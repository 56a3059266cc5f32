"""How the loss kernels B3, B8 and B7 and the probe kernel X4 split a slate
over a thread-block cluster, checked on the CPU: the cluster sizes and
shared-memory bytes the wrappers pass to ``csrc/lambda_pairs.cu``,
``csrc/neuralsort_cluster.cu``, ``csrc/sinkhorn_cluster.cu`` and
``csrc/neuralsort_layout.cu``, and that every row of a slate falls to
exactly one block (and warp). Also the CPU side of B8's and B7's routes:
each takes the plain version."""

import pytest
import torch

from allrank_tpu_torch.ops import (
    _build,
    lambda_pairs,
    neuralsort,
    neuralsort_layout,
    sinkhorn,
)


@pytest.mark.parametrize("backward", [False, True])
def test_soft_sort_cluster_plan_fits_every_length(backward):
    for l in range(1, neuralsort.MAX_FUSED_LENGTH + 1):
        cluster, nbytes = neuralsort.cluster_plan(l, backward)
        assert cluster in (1, 2, 4, 8)
        assert nbytes == 4 * neuralsort.cluster_smem_floats(l, cluster,
                                                           backward)
        assert nbytes <= neuralsort.SMEM_BYTES == 232_448
        covered = [i for rank in range(cluster)
                   for i in neuralsort.cluster_rows(rank, cluster, l)]
        assert covered == list(range(l))
        # each block's rows of M0 are inside its bytes, and inside the
        # registers of its 16 warps during the loop: lane l on rows l +
        # 32 k, warp w on its column quads, at most 64 floats a thread
        per = max(len(neuralsort.cluster_rows(r, cluster, l))
                  for r in range(cluster))
        assert 4 * per * -(-l // 4) * 4 < nbytes
        same, (rows_per_lane, quads_per_warp) = neuralsort.register_shape(l)
        assert same == cluster
        assert per <= 32 * rows_per_lane
        assert -(-l // 4) <= 16 * quads_per_warp
        assert 4 * rows_per_lane * quads_per_warp <= 64


@pytest.mark.parametrize("l,backward,want", [
    (1, False, 1), (70, True, 1), (128, True, 1), (129, False, 2),
    (240, False, 2), (240, True, 2), (241, True, 2), (256, True, 2),
    (257, False, 8), (300, True, 8), (361, False, 8), (512, False, 8),
    (512, True, 8)])
def test_soft_sort_cluster_sizes_at_the_main_lengths(l, backward, want):
    """L = 240 (the recipes) on two blocks of 115,200 bytes of M0 each;
    L = 512 on eight of 131,072."""
    assert neuralsort.cluster_plan(l, backward)[0] == want


def test_soft_sort_route_covers_the_envelope_and_no_more():
    assert {neuralsort.route(l) for l in range(1, 513)} == {"cluster"}
    for l in (0, 513, 640):
        with pytest.raises(NotImplementedError):
            neuralsort.route(l)
        with pytest.raises(NotImplementedError):
            neuralsort.cluster_plan(l, False)
    assert neuralsort.ROUTES == ("cluster", "l2")


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_lambda_pairs_row_split_covers_every_row_once(direction):
    """Every row of a top-k block of 1..384 falls to one warp of one block
    of its cluster (the kernels' walk, both directions alike)."""
    warps = lambda_pairs.CLUSTER_WARPS
    for k in range(1, lambda_pairs.MAX_FUSED_LENGTH + 1):
        cluster = lambda_pairs.cluster_size(k)
        assert cluster in (1, 2, 4)
        rows = sorted(i for rank in range(cluster) for w in range(warps)
                      for i in lambda_pairs.rows_of(rank, w, cluster, k))
        assert rows == list(range(k)), (direction, k)
    for k in (0, 385):
        with pytest.raises(ValueError):
            lambda_pairs.cluster_size(k)


def test_lambda_pairs_short_k_eff_spreads_over_the_cluster():
    """At k = 240 with k_eff = 10 each of the four blocks takes live rows."""
    cluster = lambda_pairs.cluster_size(240)
    assert cluster == 4
    for rank in range(cluster):
        live = [i for w in range(lambda_pairs.CLUSTER_WARPS)
                for i in lambda_pairs.rows_of(rank, w, cluster, 240)
                if i < 10]
        assert live


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("way", ["cluster", "l2"])
def test_soft_sort_routes_take_the_plain_version_on_the_cpu(way, transpose):
    gen = torch.Generator().manual_seed(3)
    s = torch.randn(3, 9, generator=gen)
    pad = torch.zeros(3, 9)
    pad[1, 6:] = 1.0
    vec = torch.rand(3, 9, generator=gen)
    dout = torch.randn(3, 9, generator=gen)
    want = neuralsort.soft_sort_fwd_plain(s, pad, vec, 0.8, 7, transpose)
    got = neuralsort.launch_fwd(way, s, pad, vec, 0.8, 7, transpose)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(
        neuralsort.launch_bwd(way, s, pad, vec, *want[1:], dout, 0.8, 7,
                              transpose),
        neuralsort.soft_sort_bwd_plain(s, pad, vec, *want[1:], dout, 0.8, 7,
                                       transpose))
    leaf = s.clone().requires_grad_()
    out = neuralsort.fused_soft_sort_contract(leaf, pad, vec, tau=0.8,
                                              max_iter=7,
                                              transpose=transpose, way=way)
    assert torch.equal(out.detach(), want[0])
    out.sum().backward()
    ref = s.clone().requires_grad_()
    neuralsort.fused_soft_sort_contract(ref, pad, vec, tau=0.8, max_iter=7,
                                        transpose=transpose).sum().backward()
    assert torch.equal(leaf.grad, ref.grad)
    with pytest.raises(ValueError, match="route"):
        neuralsort.launch_fwd("dram", s, pad, vec, 0.8, 7, transpose)


@pytest.mark.parametrize("backward", [False, True])
def test_sinkhorn_cluster_plan_fits_every_length(backward):
    """B7's "cluster" route at every L of its envelope: a cluster of 1-16
    blocks, the smallest whose blocks fit in both directions, each block's
    rows of M0 inside its bytes, every row on exactly one block."""
    for l in range(1, sinkhorn.MAX_FUSED_LENGTH + 1):
        cluster, nbytes = sinkhorn.cluster_plan(l, backward)
        assert cluster in (1, 2, 4, 8, 16)
        assert cluster == sinkhorn.cluster_plan(l, not backward)[0]
        assert nbytes == 4 * sinkhorn.cluster_smem_floats(l, cluster,
                                                          backward)
        assert nbytes <= sinkhorn.SMEM_BYTES == 232_448
        covered = [i for rank in range(cluster)
                   for i in sinkhorn.cluster_rows(rank, cluster, l)]
        assert covered == list(range(l))
        per = max(len(sinkhorn.cluster_rows(r, cluster, l))
                  for r in range(cluster))
        assert 4 * per * -(-l // 4) * 4 < nbytes
        if cluster > 1:
            assert 4 * max(sinkhorn.cluster_smem_floats(l, cluster // 2, bw)
                           for bw in (False, True)) > sinkhorn.SMEM_BYTES


@pytest.mark.parametrize("l,want", [
    (1, 1), (228, 1), (229, 2), (322, 2), (323, 4), (456, 4), (457, 8),
    (520, 8), (640, 8), (641, 16), (768, 16)])
def test_sinkhorn_cluster_sizes_at_the_main_lengths(l, want):
    """L = 640 (the NeuralNDCG step past B8's 512) on eight blocks of
    204,800 bytes of M0 each, one wave of eight slates; L = 768 on 16."""
    assert sinkhorn.cluster_plan(l, False)[0] == want


def test_sinkhorn_route_covers_the_envelope_and_no_more():
    assert {sinkhorn.route(l) for l in range(1, 769)} == {"cluster"}
    for l in (0, 769, 1024):
        with pytest.raises(NotImplementedError):
            sinkhorn.route(l)
        with pytest.raises(NotImplementedError):
            sinkhorn.cluster_plan(l, True)
    assert sinkhorn.ROUTES == ("cluster", "l2")


@pytest.mark.parametrize("way", ["cluster", "l2"])
def test_sinkhorn_routes_take_the_plain_version_on_the_cpu(way):
    gen = torch.Generator().manual_seed(4)
    m0 = torch.softmax(torch.randn(3, 9, 9, generator=gen), dim=-1)
    m0[1, 6:, :] = 0.0
    m0[1, :, 6:] = 0.0
    m0[1, 6:, 6:] = 1.0
    dp = torch.randn(3, 9, 9, generator=gen)
    launches = (sinkhorn.sinkhorn_fwd.launches,
                dict(sinkhorn.sinkhorn_fwd.route_launches))
    want = sinkhorn.sinkhorn_fwd_plain(m0, 7)
    got = sinkhorn.launch_fwd(way, m0, 7)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(
        sinkhorn.launch_bwd(way, m0, *want[1:], dp, 7),
        sinkhorn.sinkhorn_bwd_plain(m0, *want[1:], dp, 7))
    # the CPU launches no kernel
    assert launches == (sinkhorn.sinkhorn_fwd.launches,
                        dict(sinkhorn.sinkhorn_fwd.route_launches))
    with pytest.raises(ValueError, match="route"):
        sinkhorn.launch_fwd("dram", m0, 7)


@pytest.mark.parametrize("backward", [False, True])
def test_layout_plan_fits_every_length_to_its_cap(backward):
    """X4 at B8's own cluster size at every L up to its cap at T = 50
    (384), its backward's stacks in the room of M0's rows; one past the
    cap, a direction does not fit."""
    cap = neuralsort_layout.max_length(50)
    assert cap == 384
    for l in range(1, cap + 1):
        cluster, nbytes = neuralsort_layout.layout_plan(l, 50, backward)
        assert cluster == neuralsort.cluster_plan(l, backward)[0]
        assert nbytes == 4 * neuralsort_layout.smem_floats(l, cluster, 50,
                                                           backward)
        assert nbytes <= neuralsort_layout.SMEM_BYTES
        if not backward:
            # B8's floats and the block's two records [T + 1, round4(R)]
            rows = len(neuralsort.cluster_rows(0, cluster, l))
            assert nbytes == (neuralsort.cluster_plan(l, False)[1]
                              + 8 * 51 * -(-rows // 4) * 4)
    assert max(neuralsort_layout.layout_plan(cap + 1, 50, bw)[1]
               for bw in (False, True)) > neuralsort_layout.SMEM_BYTES


@pytest.mark.parametrize("max_iter,cap", [(20, 512), (50, 384), (100, 120)])
def test_layout_cap_follows_the_iterations(max_iter, cap):
    assert neuralsort_layout.max_length(max_iter) == cap
    neuralsort_layout.check_length(cap, max_iter)
    with pytest.raises(ValueError, match=f"L <= {cap}"):
        neuralsort_layout.check_length(cap + 1, max_iter)


class _OccupancyLibrary:
    """A stand-in for a kernel library's occupancy query: returns ``got``
    and counts its calls."""

    def __init__(self, got):
        self.got, self.calls = got, 0

    def occupancy(self, *args):
        self.calls += 1
        return self.got

    def kernel_error_string(self, rc):
        return b"invalid argument"


@pytest.mark.parametrize("got", [7, 0, -1])
def test_cluster_occupancy_is_asked_once_and_raises_on_none(got):
    """The wrappers of B7, B8 and X4 size their grids by one shared query:
    asked once a device and arguments, and a card that holds no cluster,
    or a failed query, raises; nothing falls back."""
    lib = _OccupancyLibrary(got)
    args = (1, 240, 2, 186_720 + got)  # a key no other test takes
    if got > 0:
        for _ in range(3):
            assert _build.cluster_occupancy(lib, "occupancy", -1,
                                            *args) == got
        assert lib.calls == 1
        return
    match = "holds no cluster of 2 blocks" if got == 0 else "invalid"
    for _ in range(2):
        with pytest.raises(RuntimeError, match=match):
            _build.cluster_occupancy(lib, "occupancy", -1, *args)
    assert lib.calls == 2
