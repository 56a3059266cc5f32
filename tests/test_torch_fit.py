"""The port's training loop against the JAX package's pieces: the schedulers
value for value, checkpoints that either package loads, ``fit`` on dummy
data, resume, and the train CLI end to end on the CPU with cut-down copies
of the paper recipes."""

import json
import math
import os
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allrank_tpu.training.schedulers as js
import allrank_tpu_torch.training.schedulers as ts
from allrank_tpu.config import Config as JaxConfig
from allrank_tpu.models.factory import forward as jax_forward
from allrank_tpu.models.factory import init_params
from allrank_tpu.models.factory import make_model as jax_make_model
from allrank_tpu.training.checkpoint import load_params as jax_load_params
from allrank_tpu.training.checkpoint import save_params as jax_save_params
from allrank_tpu.training.early_stop import EarlyStop as JaxEarlyStop
from allrank_tpu_torch.config import Config, MetricConfigError
from allrank_tpu_torch.data.batching import SlateBatcher
from allrank_tpu_torch.data.dataset import SlateDataset
from allrank_tpu_torch.data.dummy import (
    generate_dummy_data,
    write_dummy_dataset,
)
from allrank_tpu_torch.losses import get_loss
from allrank_tpu_torch.main import run
from allrank_tpu_torch.models.factory import LTRModel, make_model
from allrank_tpu_torch.training import (
    fit,
    get_learning_rate,
    make_optimizer,
    make_scheduler,
)
from allrank_tpu_torch.training.checkpoint import (
    load_opt_state,
    load_params,
    save_opt_state,
    save_params,
)
from allrank_tpu_torch.training.early_stop import EarlyStop
from allrank_tpu_torch.training.train_utils import (
    compute_metrics,
    make_eval_fns,
)
from allrank_tpu_torch.utils.experiments import assert_expected_metrics
from allrank_tpu_torch.utils.file_utils import PathsContainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEURAL = os.path.join(REPO, "reproducibility", "configs", "neuralndcg_web30k",
                      "neuralndcg_atmax.json")
LAMBDA = os.path.join(REPO, "reproducibility", "configs",
                      "contextaware_web30k", "ndcgloss2pp.json")
RECIPES = ["neuralndcg_atmax", "ndcgloss2pp"]
APPROX = os.path.join(REPO, "reproducibility", "configs", "neuralndcg_web30k",
                      "approxndcg.json")
ORDINAL = os.path.join(REPO, "reproducibility", "configs",
                       "contextaware_web30k", "ordinal.json")
ORDINAL_MLP = os.path.join(REPO, "reproducibility", "configs",
                           "contextaware_web30k", "ordinal_mlp.json")

SCHEDULERS = [
    ("StepLR", {"step_size": 50, "gamma": 0.1}),
    ("MultiStepLR", {"milestones": [30, 10, 80], "gamma": 0.5}),
    ("ExponentialLR", {"gamma": 0.97}),
    ("ConstantLR", {"factor": 0.25, "total_iters": 7}),
    ("CosineAnnealingLR", {"T_max": 40, "eta_min": 1e-5}),
    ("CosineAnnealingWarmRestarts", {"T_0": 1, "T_mult": 3}),
    ("LinearLR", {"start_factor": 0.1, "total_iters": 20}),
    ("LambdaLR", {"lr_lambda": "0.95 ** epoch"}),
    ("ReduceLROnPlateau", {"mode": "max", "factor": 0.5, "patience": 2,
                           "cooldown": 1, "min_lr": 1e-6}),
]


@pytest.mark.parametrize("name,args", SCHEDULERS)
def test_scheduler_matches_jax_over_120_epochs(name, args):
    mine = make_scheduler(name, args, 1e-3)
    ref = js.make_scheduler(name, args, 1e-3)
    assert type(mine).__name__ == type(ref).__name__ == name
    assert mine.needs_metric == ref.needs_metric
    assert mine.current_lr == ref.current_lr
    rng = np.random.RandomState(0)
    for _ in range(120):
        metric = float(rng.rand()) if mine.needs_metric else None
        assert mine.step(metric) == ref.step(metric)
    assert mine.last_epoch == ref.last_epoch == 120


def test_scheduler_registry_and_early_stop_match_jax():
    assert sorted(ts.SCHEDULERS) == sorted(js.SCHEDULERS)
    with pytest.raises(ValueError, match="Unknown lr_scheduler"):
        make_scheduler("nope", {}, 1e-3)
    with pytest.raises(ValueError, match="requires the tracked metric"):
        make_scheduler("ReduceLROnPlateau", {}, 1e-3).step()
    mine, ref = EarlyStop(2), JaxEarlyStop(2)
    for epoch, value in enumerate([0.1, 0.3, 0.2, 0.25, 0.29, 0.1]):
        mine.step(value, epoch)
        ref.step(value, epoch)
        assert mine.stop_training(epoch) == ref.stop_training(epoch)
        assert mine.__dict__ == ref.__dict__
    assert mine.stop_training(5) and not EarlyStop(0).stop_training(99)


def _tiny_cfg(path, data_dir, **training):
    """A paper recipe cut down to dummy-data size: narrow widths, 12-document
    slates, fp32; the loss, optimizer, scheduler and metrics as written."""
    with open(path) as f:
        cfg = json.load(f)
    cfg["data"].update(path=data_dir, slate_length=12, batch_size=16,
                       validation_ds_role="vali")
    # an FC tower alone keeps its depth, a transformer's input layer its one
    n_fc = len(cfg["model"]["fc_model"]["sizes"])
    cfg["model"]["fc_model"]["sizes"] = [16, 32, 16][:n_fc]
    if cfg["model"]["transformer"] is not None:
        cfg["model"]["transformer"].update(d_ff=32, h=min(
            2, cfg["model"]["transformer"]["h"]))
    cfg["training"].update(epochs=3, compute_dtype="float32", **training)
    cfg["metrics"] = ["ndcg_5", "ndcg_10"]
    cfg["expected_metrics"] = {"val": {"ndcg_5": 0.5}}
    return cfg


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_dummy_dataset(str(tmp_path_factory.mktemp("dummy")),
                               num_queries=64, results_len=12,
                               num_features=16)


def _model(cfg_dict, seed=0):
    cfg = Config.from_dict(cfg_dict)
    return cfg, LTRModel(make_model(cfg.model, 16),
                         torch.Generator().manual_seed(seed), device="cpu")


def _dataset(seed=7):
    X, y, qid = generate_dummy_data(64, 12, 5, 16,
                                    np.random.RandomState(seed))
    return SlateDataset(X, y, qid)


def _fit_kwargs(cfg, model, ds, **overrides):
    loss_fn, needs_rng = get_loss(cfg.loss.name)
    kwargs = dict(
        epochs=4, model=model, loss_fn=loss_fn, loss_kwargs=cfg.loss.args,
        needs_rng=needs_rng,
        optimizer=make_optimizer("Adam", {"lr": 1e-2}, model.parameters()),
        scheduler=make_scheduler("StepLR", {"step_size": 2, "gamma": 0.5},
                                 1e-2),
        train_batcher=SlateBatcher(ds, 12, 16, shuffle=True, seed=1),
        val_batcher=SlateBatcher(ds, 12, 16, shuffle=False, seed=1),
        metrics={"ndcg": [5], "mrr": [10]}, val_metric="ndcg_5",
        early_stopping_patience=0, gradient_clipping_norm=1.0)
    kwargs.update(overrides)
    return kwargs


@pytest.mark.parametrize("path", [NEURAL, LAMBDA], ids=RECIPES)
def test_fit_learns_on_dummy_data(path, data_dir):
    cfg, model = _model(_tiny_cfg(path, data_dir))
    ds = _dataset()
    loss_fn, needs_rng = get_loss(cfg.loss.name)
    eval_step = make_eval_fns(model, loss_fn, cfg.loss.args, needs_rng,
                              {"ndcg": [5]})
    before, _ = compute_metrics(
        eval_step, SlateBatcher(ds, 12, 16), torch.Generator())
    kwargs = _fit_kwargs(cfg, model, ds)
    result = fit(**kwargs)
    assert result["epochs"] == 4 and result["model"] is model
    assert result["num_params"] == sum(p.numel() for p in model.parameters())
    assert set(result["val_metrics"]) == {"ndcg_5", "mrr_10"}
    assert result["val_metrics"]["ndcg_5"] > before["ndcg_5"] + 0.05
    assert result["val_metrics"]["ndcg_5"] > 0.8
    # train and validation sets are one dataset here; eval has no dropout
    assert result["train_metrics"]["ndcg_5"] == pytest.approx(
        result["val_metrics"]["ndcg_5"], abs=1e-6)
    # StepLR(2, 0.5) stepped four times from 1e-2
    assert math.isclose(get_learning_rate(kwargs["optimizer"]), 2.5e-3)


def test_fit_steps_a_plateau_scheduler_on_the_validation_metric(data_dir):
    cfg, model = _model(_tiny_cfg(NEURAL, data_dir))
    seen = []

    class Recorder(ts.ReduceLROnPlateau):
        def step(self, metric=None):
            seen.append(metric)
            return super().step(metric)

    kwargs = _fit_kwargs(cfg, model, _dataset(), epochs=3,
                         scheduler=Recorder(1e-2, mode="max", patience=0,
                                            factor=0.5, threshold=10.0))
    result = fit(**kwargs, metrics_on_train=False)
    assert len(seen) == 3 and seen[-1] == result["val_metrics"]["ndcg_5"]
    assert result["train_metrics"] == {}
    # an unreachable threshold: the rate halves after epochs 2 and 3
    assert get_learning_rate(kwargs["optimizer"]) == 1e-2 * 0.25


def test_fit_stops_early_and_rejects_unported_options(data_dir):
    cfg, model = _model(_tiny_cfg(NEURAL, data_dir))
    ds = _dataset()
    opt = make_optimizer("SGD", {"lr": 0.0}, model.parameters())
    result = fit(**_fit_kwargs(cfg, model, ds, epochs=9, optimizer=opt,
                               scheduler=None, early_stopping_patience=1,
                               metrics_on_train=False))
    assert result["epochs"] == 3  # no improvement after epoch 0
    # profiler_trace_dir is ported (tests/test_torch_host_data.py)
    for kw in ({"checkpoint_backend": "orbax"}, {"scan_steps": 4}):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            fit(**_fit_kwargs(cfg, model, ds, **kw))
    with pytest.raises(ValueError, match="checkpoint_backend"):
        fit(**_fit_kwargs(cfg, model, ds, checkpoint_backend="pickle"))


@pytest.mark.parametrize("path", [NEURAL, LAMBDA], ids=RECIPES)
def test_model_npz_round_trips_between_the_packages(path, data_dir, tmp_path):
    cfg_dict = _tiny_cfg(path, data_dir)
    cfg, model = _model(cfg_dict, seed=3)
    jcfg = JaxConfig.from_dict(cfg_dict)
    mdef = jax_make_model(jcfg.model, 16)
    rng = np.random.RandomState(0)
    x = rng.randn(4, 12, 16).astype(np.float32)
    mask = np.arange(12)[None, :] >= np.array([12, 7, 3, 0])[:, None]
    indices = np.where(mask, -1, np.arange(12)[None, :])

    def jax_scores(params):
        return np.asarray(jax_forward(params, mdef, jnp.asarray(x),
                                      jnp.asarray(mask),
                                      jnp.asarray(indices)))

    def torch_scores(m):
        with torch.no_grad():
            return m(torch.tensor(x), torch.tensor(mask),
                     torch.tensor(indices)).numpy()

    # the port's file into the JAX package
    ours = save_params(model, str(tmp_path / "ours" / "model.npz"))
    template = init_params(jax.random.PRNGKey(0), mdef)
    loaded = jax_load_params(template, ours)
    np.testing.assert_allclose(jax_scores(loaded), torch_scores(model),
                               rtol=0, atol=1e-5)
    # the JAX package's file into the port
    theirs = jax_save_params(init_params(jax.random.PRNGKey(1), mdef),
                             str(tmp_path / "theirs.npz"))
    other = load_params(_model(cfg_dict, seed=4)[1], theirs)
    np.testing.assert_allclose(
        torch_scores(other),
        jax_scores(jax_load_params(template, theirs)), rtol=0, atol=1e-5)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
    with pytest.raises(NotImplementedError, match="gs://"):
        load_params(model, "gs://bucket/model.npz")


def test_opt_state_round_trips(tmp_path):
    def trained(steps):
        torch.manual_seed(0)
        w = [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(
            torch.ones(2, 2))]
        opt = make_optimizer("Adam", {"lr": 0.1}, w)
        for i in range(steps):
            opt.zero_grad()
            (w[0].sum() * (i + 1) + (w[1] ** 2).sum()).backward()
            opt.step()
        return w, opt

    w, opt = trained(3)
    path = save_opt_state(opt, str(tmp_path / "opt_state.npz"))
    fresh_w, fresh = trained(0)
    with torch.no_grad():
        for a, b in zip(fresh_w, w):
            a.copy_(b)
    load_opt_state(fresh, path)
    for o, params in ((opt, w), (fresh, fresh_w)):
        o.zero_grad()
        (params[0].sum() + (params[1] ** 2).sum()).backward()
        o.step()
    for a, b in zip(w, fresh_w):
        assert torch.equal(a, b)


@pytest.mark.parametrize("path", [NEURAL, LAMBDA], ids=RECIPES)
def test_resume_continues_to_the_same_weights(path, data_dir, tmp_path):
    """Dropout is on (0.1 and 0.3 in the recipes): the resumed run must
    restore the generator states to reach the same bits."""
    ds = _dataset()

    def run_fit(out, epochs, seed=0, **kw):
        cfg, model = _model(_tiny_cfg(path, data_dir), seed=seed)
        return fit(**_fit_kwargs(cfg, model, ds, epochs=epochs,
                                 output_dir=str(tmp_path / out), **kw))

    whole = run_fit("whole", 4)
    run_fit("split", 2, checkpoint_every=1)
    partial = tmp_path / "split" / "partial"
    with open(partial / "loop_state.json") as f:
        state = json.load(f)
    assert state["epoch"] == 1 and state["scheduler"]["last_epoch"] == 2
    assert sorted(os.listdir(partial)) == ["loop_state.json", "opt_state.npz",
                                           "params.npz"]
    # other initial weights: everything must come from the checkpoint
    resumed = run_fit("split", 4, seed=5, checkpoint_every=1, resume=True)
    assert resumed["epochs"] == 4
    assert resumed["val_metrics"] == whole["val_metrics"]
    for (name, a), (_, b) in zip(whole["model"].state_dict().items(),
                                 resumed["model"].state_dict().items()):
        assert torch.equal(a, b), name
    with np.load(tmp_path / "whole" / "model.npz") as a, np.load(
            tmp_path / "split" / "model.npz") as b:
        assert all(np.array_equal(a[k], b[k]) for k in a.files)


@pytest.mark.parametrize("path,run_id", [
    (NEURAL, "neural"), (LAMBDA, "lambda"), (APPROX, "approx"),
    (ORDINAL, "ordinal"), (ORDINAL_MLP, "ordinal_mlp")],
    ids=RECIPES + ["approxndcg", "ordinal", "ordinal_mlp"])
def test_cli_runs_the_paper_recipes_end_to_end(path, run_id, data_dir,
                                               tmp_path):
    config_path = str(tmp_path / "config.json")
    cfg_dict = _tiny_cfg(path, data_dir)
    if Config.from_json(path).loss.name == "ordinal":
        # the 4-output sigmoid head scores by the sum of its outputs
        assert cfg_dict["model"]["post_model"] == {
            "output_activation": "Sigmoid", "d_output": 4}
    with open(config_path, "w") as f:
        json.dump(cfg_dict, f)
    job_dir = str(tmp_path / "job")
    args = Namespace(job_dir=job_dir, run_id=run_id,
                     config_file_name=config_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(args)  # no GPU here and no explicit CPU
    result = run(args, device="cpu")
    assert result["epochs"] == 3
    assert result["val_metrics"]["ndcg_5"] > 0.5  # the gate asserted it too
    out_dir = os.path.join(job_dir, "results", run_id)
    for name in ("experiment_result.json", "model.npz", "used_config.json",
                 "training.log"):
        assert os.path.getsize(os.path.join(out_dir, name)) > 0
    with open(os.path.join(out_dir, "experiment_result.json")) as f:
        dumped = json.load(f)
    assert dumped["run_id"] == run_id and dumped["epochs"] == 3
    assert dumped["val_metrics/ndcg_5"] == result["val_metrics"]["ndcg_5"]
    assert dumped["loss/name"] == Config.from_json(path).loss.name
    with open(os.path.join(job_dir, "tb_evals", "single", run_id,
                           "loss_train", "scalars.jsonl")) as f:
        losses = [json.loads(line)["value"] for line in f]
    assert len(losses) == 3 and np.isfinite(losses).all()
    # the written model is the trained one and loads into a fresh model
    fresh = _model(_tiny_cfg(path, data_dir), seed=9)[1]
    load_params(fresh, os.path.join(out_dir, "model.npz"))
    for (name, a), (_, b) in zip(fresh.state_dict().items(),
                                 result["model"].state_dict().items()):
        assert torch.equal(a, b), name


def test_cli_gate_failure_and_unported_options_raise(data_dir, tmp_path):
    cfg = _tiny_cfg(NEURAL, data_dir)
    cfg["training"]["epochs"] = 1
    cfg["expected_metrics"] = {"val": {"ndcg_5": 1.01}}  # impossible
    config_path = str(tmp_path / "config.json")
    with open(config_path, "w") as f:
        json.dump(cfg, f)
    args = Namespace(job_dir=str(tmp_path / "job"), run_id="fail",
                     config_file_name=config_path)
    with pytest.raises(AssertionError, match="expected to be at least 1.01"):
        run(args, device="cpu")
    assert_expected_metrics({"val_metrics": {"ndcg_5": 0.4}}, {})
    # data.device_cache, ported since, trains to the same gate
    cfg["data"]["device_cache"] = True
    with open(config_path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(AssertionError, match="expected to be at least 1.01"):
        run(args, device="cpu")
    with pytest.raises(NotImplementedError, match="gs://"):
        PathsContainer.from_args("gs://bucket/job", "r", config_path)


def test_config_reads_the_fields_main_needs():
    cfg = Config.from_json(NEURAL)
    ref = JaxConfig.from_json(NEURAL)
    assert cfg.metrics == ref.metrics == {"ndcg": [5, 10, 30, 60]}
    assert cfg.val_metric == ref.val_metric == "ndcg_5"
    assert cfg.expected_metrics == ref.expected_metrics
    assert cfg.detect_anomaly is ref.detect_anomaly is False
    assert cfg.data.validation_ds_role == "test"
    for field in ("model", "data", "optimizer", "loss", "lr_scheduler",
                  "training", "metrics", "val_metric", "expected_metrics"):
        assert cfg.to_dict()[field] == ref.to_dict()[field], field
    with pytest.raises(MetricConfigError, match="Wrong metric format"):
        Config.from_dict({**json.load(open(NEURAL)), "metrics": ["ndcg"]})
