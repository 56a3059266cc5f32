"""How the loss kernels B3 and B8 split a slate over a thread-block cluster,
checked on the CPU: the cluster sizes and shared-memory bytes the wrappers
pass to ``csrc/lambda_pairs.cu`` and ``csrc/neuralsort_cluster.cu``, and
that every row of a slate falls to exactly one block (and warp). Also the
CPU side of B8's routes: each takes the plain version."""

import pytest
import torch

from allrank_tpu_torch.ops import lambda_pairs, neuralsort


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
