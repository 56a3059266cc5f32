"""The port's offline evaluation CLI (allrank_tpu_torch/evaluate.py) against
the JAX package's, float and through the int8 tower, and the two inputs it
reads: the config (every section kept, unknown ones refused) and the libsvm
parser (features counted as the JAX parser counts them)."""

import glob
import json
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from allrank_tpu.config import Config as JaxConfig
from allrank_tpu.data.dataset import parse_svmlight as jax_parse
from allrank_tpu.data.dummy import write_dummy_dataset
from allrank_tpu.evaluate import run as jax_evaluate
from allrank_tpu.models import factory as jfactory
from allrank_tpu.training.checkpoint import save_params
from allrank_tpu_torch.config import Config, ParallelConfig
from allrank_tpu_torch.data.dataset import parse_svmlight
from allrank_tpu_torch.evaluate import parse_args
from allrank_tpu_torch.evaluate import run as evaluate
from allrank_tpu_torch.utils.device import require_one_device
from tools.fuzz_libsvm import gen_file

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "reproducibility", "configs",
                                        "*", "*.json")))
F = 16


# -- the config (C1) ----------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_config_to_dict_is_the_jax_one(path):
    assert Config.from_json(path).to_dict() == \
        JaxConfig.from_json(path).to_dict()


def test_config_refuses_an_unknown_section_as_jax_does():
    with open(CONFIGS[0]) as f:
        raw = json.load(f)
    raw["clik_model"] = {"name": "x"}
    with pytest.raises(TypeError):
        JaxConfig.from_dict(raw)
    with pytest.raises(TypeError, match="clik_model"):
        Config.from_dict(raw)


def test_layouts_of_more_than_one_device_are_refused(monkeypatch):
    require_one_device(ParallelConfig())
    require_one_device(ParallelConfig(data=1, model=1, sequence=1))
    for kw in ({"data": 2}, {"model": 2}, {"sequence": 4}):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            require_one_device(ParallelConfig(**kw))
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(NotImplementedError, match="multi-process"):
        require_one_device(ParallelConfig())


# -- the parser (C2) ----------------------------------------------------------

def test_a_file_without_features_has_one_feature():
    for parse in (jax_parse, parse_svmlight):
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "f.txt")
            with open(path, "w") as f:
                f.write("0.56 qid:557558# c\n")
            x, y, qid = parse(path)
        assert x.shape == (1, 1) and not x.any()
        np.testing.assert_array_equal(y, np.float32([0.56]))
        np.testing.assert_array_equal(qid, [557558])


@pytest.mark.parametrize("first", [0, 300, 600, 900])
def test_parser_matches_jax_on_fuzzed_files(first):
    """tools/fuzz_libsvm.gen_file's adversarial files (seeds 201, 360 and
    1105 among them have no feature at all): X, y and qid equal the JAX
    parser's, shapes and dtypes included."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "case.txt")
        for seed in range(first, first + 300):
            gen_file(np.random.RandomState(seed), path)
            for got, ref in zip(parse_svmlight(path), jax_parse(path)):
                assert got.dtype == ref.dtype and got.shape == ref.shape, seed
                np.testing.assert_array_equal(got, ref, err_msg=str(seed))


# -- the evaluate CLI -------------------------------------------------------

def _config(data_path, expected=None):
    return {
        "model": {
            "fc_model": {"sizes": [24], "input_norm": True,
                         "activation": "ReLU", "dropout": None},
            "transformer": {"N": 1, "d_ff": 32, "h": 2, "dropout": 0.0,
                            "positional_encoding": {"strategy": "fixed",
                                                    "max_indices": 20}},
            "post_model": {"d_output": 1},
        },
        "data": {"path": data_path, "num_workers": 0, "batch_size": 16,
                 "slate_length": 12, "validation_ds_role": "vali"},
        "optimizer": {"name": "Adam", "args": {"lr": 1e-2}},
        "lr_scheduler": {"name": "StepLR",
                         "args": {"step_size": 10, "gamma": 0.1}},
        "training": {"epochs": 1, "gradient_clipping_norm": None},
        "loss": {"name": "listNet", "args": {}},
        "metrics": ["ndcg_5", "ndcg_10", "map_5"],
        "val_metric": "ndcg_5",
        "expected_metrics": expected or {},
        # one JAX device, the port's one device: the same batches
        "parallel": {"data": 1},
    }


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Dummy data (slates of 9 documents, shorter than the train role's 12:
    padded, never subsampled), a config and a model.npz of seeded random
    weights written by the JAX package."""
    root = tmp_path_factory.mktemp("evaluate")
    data = str(root / "data")
    write_dummy_dataset(data, num_queries=40, results_len=9, num_features=F)
    cfg_path = str(root / "config.json")
    with open(cfg_path, "w") as f:
        json.dump(_config(data), f)
    mdef = jfactory.make_model(JaxConfig.from_json(cfg_path).model, F)
    params = jax.tree.map(np.asarray,
                          jfactory.init_params(jax.random.PRNGKey(3), mdef))
    model = str(root / "model.npz")
    save_params(params, model)
    return root, data, cfg_path, model


def _args(root, run_id, cfg_path, model, roles=("vali", "train"), **kw):
    """The CLI's arguments (its defaults included), ``kw`` set over them."""
    args = parse_args(["--job-dir", str(root / "job"), "--run-id", run_id,
                       "--config-file-name", cfg_path,
                       "--input-model-path", model, "--roles",
                       ",".join(roles)])
    vars(args).update(kw)
    return args


def _read(root, run_id, name):
    with open(os.path.join(root / "job", "results", run_id, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("quantize", [None, "int8_static"])
def test_evaluate_matches_jax(job, quantize):
    root, _, cfg_path, model = job
    kw = dict(quantize=quantize, calibration_role="train",
              calibration_batches=2)
    ref = jax_evaluate(_args(root, f"jax_{quantize}", cfg_path, model, **kw))
    got = evaluate(_args(root, f"torch_{quantize}", cfg_path, model, **kw),
                   device="cpu")
    assert sorted(got) == sorted(ref) == ["train", "vali"]
    flat_ref = _read(root, f"jax_{quantize}", "evaluation_result.json")
    flat = _read(root, f"torch_{quantize}", "evaluation_result.json")
    assert sorted(flat) == sorted(flat_ref)
    assert "vali/ndcg_5" in flat and "train/loss" in flat
    for key in flat_ref:
        # through the int8 tower the loss moves with every score, and an
        # activation that the two packages' LayerNorms put an fp32 ulp
        # apart can round to neighbouring int8 steps: one such flip moves
        # this loss by 5.1e-5 (1.8e-5 of it); the metrics move only if an
        # order flips
        tol = (dict(rel=1e-4) if quantize and key.endswith("/loss")
               else dict(abs=1e-5))
        assert flat[key] == pytest.approx(flat_ref[key], **tol), key
    if quantize:
        scales_ref = _read(root, f"jax_{quantize}", "act_scales.json")
        scales = _read(root, f"torch_{quantize}", "act_scales.json")
        assert sorted(scales) == sorted(scales_ref)
        for site in scales_ref:
            np.testing.assert_allclose(scales[site], scales_ref[site],
                                       rtol=1e-6, err_msg=site)


def test_evaluate_gate_fails_on_unmet_expectation(job, tmp_path):
    root, data, _, model = job
    gated = str(tmp_path / "gated.json")
    with open(gated, "w") as f:
        # "val" stands for data.validation_ds_role
        json.dump(_config(data, expected={"val": {"ndcg_5": 1.01}}), f)
    with pytest.raises(AssertionError, match="expected to be at least"):
        evaluate(_args(root, "gated", gated, model, roles=["vali"]),
                 device="cpu")
    met = str(tmp_path / "met.json")
    with open(met, "w") as f:
        json.dump(_config(data, expected={"val": {"ndcg_5": 0.0},
                                          "test": {"ndcg_5": 2.0}}), f)
    out = evaluate(_args(root, "met", met, model, roles=["vali"],
                         quantize="int8"), device="cpu")
    assert 0.0 <= out["vali"]["ndcg_5"] <= 1.0


def test_evaluate_refuses_what_is_not_ported(job, tmp_path):
    """A layout of two devices raises; data.binary_cache, ported since,
    evaluates as the parse does."""
    root, data, _, model = job
    results = {}
    for name, edit in (("parallel", {"parallel": {"data": 2}}),
                       ("plain", {}), ("binary_cache", {"data": {
                           **_config(data)["data"], "binary_cache": True}})):
        path = str(tmp_path / f"{name}.json")
        with open(path, "w") as f:
            json.dump({**_config(data), **edit}, f)
        args = _args(root, name, path, model, roles=["vali"])
        if name == "parallel":
            with pytest.raises(NotImplementedError, match=name):
                evaluate(args, device="cpu")
        else:
            results[name] = evaluate(args, device="cpu")
    assert results["binary_cache"] == results["plain"]


def test_evaluate_cli_arguments():
    args = parse_args(["--job-dir", "j", "--run-id", "r",
                       "--config-file-name", "c.json",
                       "--input-model-path", "m.npz", "--roles", "vali,test",
                       "--quantize", "int8_static"])
    assert args.roles == ["vali", "test"]
    assert (args.quantize, args.calibration_role,
            args.calibration_batches) == ("int8_static", "train", 8)
    with pytest.raises(SystemExit):
        parse_args(["--job-dir", "j", "--run-id", "r", "--config-file-name",
                    "c", "--input-model-path", "m", "--roles", "v",
                    "--quantize", "int4"])
