"""Port parity, the training stack: repro_torch.training.{optimizer,
trainer,checkpoint} against the JAX reference, and the reference's own
end-to-end claims on the port's own run, all on the CPU at small sizes.

- AdamW: one update on identical gradients within 1e-6 under each
  schedule, with and without clipping and weight decay.
- One whole train step on the reference's params and batch (carried
  across as numpy): loss and gradients within 1e-5 of the largest
  gradient, for the LSTM pretrain and the DeltaLSTM retrain (hidden 32,
  M=4); the updated, CBTD-pruned params within 1e-4 (lr 3e-3) with the
  same zeros.
- ``tests/test_training.py``'s claims on the port's run: the loss falls,
  weight sparsity 0.75 +- 0.01, the logit layer untouched, layer-1
  ``temporal_sparsity_dh`` > 0.05 after the retrain, a resumed run
  reaches step 20 and matches the uninterrupted one (rtol 1e-4, atol
  1e-5).  The port's data stream is its own (``torch.Generator``), so
  these are claims about the port's run, not draw-for-draw equality.
- The launcher's synchronous ``--spartus`` mode on the pool and on the
  batch-1 engine.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.speech import SpeechConfig as JSpeechConfig
from repro.data.speech import SpeechDataset as JSpeechDataset
from repro.models import lstm_am as jam
from repro.training import optimizer as jopt
from repro.training import trainer as jtrainer
from repro.training.checkpoint import flatten_tree as jflatten
from repro.training.ctc import ctc_loss as jctc_loss
from repro_torch.core import tree_weight_sparsity
from repro_torch.data.speech import SpeechConfig, SpeechDataset
from repro_torch.launch import serve as tlaunch
from repro_torch.models import lstm_am as tam
from repro_torch.training import optimizer as topt
from repro_torch.training import trainer as ttrainer
from repro_torch.training.checkpoint import (
    CheckpointManager,
    flatten_tree,
    unflatten_into,
)

SMALL = ttrainer.TrainConfig(
    model=tam.LSTMAMConfig(input_dim=123, hidden_dim=32, n_layers=2,
                           n_classes=41),
    data=SpeechConfig(max_frames=48, n_classes=40),
    opt=topt.AdamWConfig(lr=3e-3),
    batch_size=8,
    steps_per_epoch=10,
    cbtd_gamma=0.75,
    cbtd_m=4,
    cbtd_delta_alpha=0.5,  # reach target sparsity after 2 epochs
)


def _leaves_np(tree):
    return {k: v for k, v in flatten_tree(tree).items()}


# -- AdamW ---------------------------------------------------------------------


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"lstm": [{"w_x": rng.standard_normal((8, 5)).astype(np.float32),
                      "b": rng.standard_normal((2, 4)).astype(np.float32)}],
            "fcl": {"w": 3 * rng.standard_normal((4, 4)).astype(np.float32)}}


@pytest.mark.parametrize("schedule", ["constant", "cosine", "linear"])
@pytest.mark.parametrize("clip_norm", [None, 1.0])
@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_adamw_update_matches_reference(schedule, clip_norm, weight_decay):
    kw = dict(lr=0.02, schedule=schedule, clip_norm=clip_norm,
              weight_decay=weight_decay, warmup_steps=2, total_steps=7)
    params, grads = _grad_tree(0), _grad_tree(1)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tam.params_from_numpy(params, device="cpu")
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    for step in range(4):       # warm-up, then the schedule's decay
        g = jax.tree.map(lambda a: a * (step + 1), grads)
        jp, js, jm = jopt.adamw_update(jax.tree.map(jnp.asarray, g), js, jp,
                                       jopt.AdamWConfig(**kw))
        tp, ts, tm = topt.adamw_update(
            tam.params_from_numpy(g, device="cpu"), ts, tp,
            topt.AdamWConfig(**kw))
        want, got = jflatten(jp), _leaves_np(tp)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], atol=1e-6,
                                       rtol=0, err_msg=key)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), abs=1e-9)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
    assert int(ts.step) == int(js.step) == 4
    for key, want in jflatten(js.v).items():
        np.testing.assert_allclose(_leaves_np(ts.v)[key], want, rtol=1e-6)


def test_schedules_and_quadratic_convergence():
    cfg = topt.AdamWConfig(lr=1.0, schedule="cosine", warmup_steps=10,
                           total_steps=110, min_lr_frac=0.1)
    fn = topt.schedule_fn(cfg)
    assert float(fn(torch.tensor(0))) == 0.0
    assert float(fn(torch.tensor(10))) == pytest.approx(1.0)
    assert float(fn(torch.tensor(110))) == pytest.approx(0.1)
    assert 0.1 < float(fn(torch.tensor(60))) < 1.0
    params = {"x": torch.tensor([5.0, -3.0])}
    state = topt.adamw_init(params)
    qcfg = topt.AdamWConfig(lr=0.1, clip_norm=None)
    for _ in range(200):
        params, state, _ = topt.adamw_update({"x": 2 * params["x"]}, state,
                                             params, qcfg)
    assert float(params["x"].abs().max()) < 0.05


# -- one whole train step --------------------------------------------------------


@pytest.mark.parametrize("delta", [False, True], ids=["lstm", "delta_lstm"])
@pytest.mark.parametrize("alpha", [0.0, 1.0])
def test_one_train_step_matches_reference(delta, alpha):
    jmodel = jam.LSTMAMConfig(input_dim=123, hidden_dim=32, n_layers=2,
                              n_classes=41, delta=delta, theta=0.05)
    jcfg = jtrainer.TrainConfig(
        model=jmodel, data=JSpeechConfig(max_frames=48, n_classes=40),
        opt=jopt.AdamWConfig(lr=3e-3), batch_size=4, cbtd_gamma=0.75,
        cbtd_m=4)
    tcfg = dataclasses.replace(SMALL, model=dataclasses.replace(
        SMALL.model, delta=delta, theta=0.05), batch_size=4)
    params = jam.init_params(jax.random.key(0), jmodel)
    batch = next(JSpeechDataset(jcfg.data, 4))

    def loss_fn(p):
        logits, _ = jam.forward(p, jmodel, batch[0])
        return jctc_loss(logits, batch[2], batch[1], batch[3])

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    tparams = tam.params_from_numpy(jax.tree.map(np.asarray, params),
                                    device="cpu")
    tbatch = tuple(torch.from_numpy(np.array(b)) for b in batch)
    loss, grads = ttrainer.loss_and_grads(tparams, tcfg, tbatch)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    want_g, got_g = jflatten(want_grads), _leaves_np(grads)
    assert sorted(want_g) == sorted(got_g)
    gmax = max(float(np.abs(g).max()) for g in want_g.values())
    for key in want_g:
        np.testing.assert_allclose(got_g[key], want_g[key], rtol=0,
                                   atol=1e-5 * gmax, err_msg=key)

    jp, _, jm = jtrainer.make_train_step(jcfg)(
        params, jopt.adamw_init(params), batch, alpha, jax.random.key(1))
    tp, ts, tm = ttrainer.make_train_step(tcfg)(
        tparams, topt.adamw_init(tparams), tbatch, alpha)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    for key, want in jflatten(jp).items():
        got = _leaves_np(tp)[key]
        np.testing.assert_array_equal(got == 0, want == 0, err_msg=key)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                   err_msg=key)
    assert int(ts.step) == 1


# -- the reference's end-to-end claims on the port's own run ----------------------


@pytest.fixture(scope="module")
def trained():
    return ttrainer.train(SMALL, epochs=3, device="cpu")


def test_loss_decreases_and_sparsity_reached(trained):
    res = trained
    assert res.steps == 30 and len(res.step_s) == 30
    first, last = np.mean(res.losses[:5]), np.mean(res.losses[-5:])
    assert last < first, f"loss did not decrease: {first} -> {last}"
    p = res.params
    ws = tree_weight_sparsity({"w_x": [l["w_x"] for l in p["lstm"]],
                               "w_h": [l["w_h"] for l in p["lstm"]],
                               "fcl": p["fcl"]["w"]})
    # gamma=0.75, subcolumn length 32*4/4 = 32 (fcl: 8) -> drop 75%
    assert ws == pytest.approx(0.75, abs=0.01)
    assert float((p["logit"]["w"] == 0).float().mean()) < 0.01
    assert all(t.device.type == "cpu" for t in
               (p["fcl"]["w"], res.opt_state.step, res.opt_state.m["fcl"]["w"]))


def test_per_evaluation_runs(trained):
    per = ttrainer.evaluate_per(trained.params, SMALL,
                                SpeechDataset(SMALL.data, 8), n_batches=1)
    assert 0.0 <= per <= 1.5   # PER can exceed 1 with insertions


def test_pretrain_retrain_pipeline():
    pre, post, retrain_cfg = ttrainer.pretrain_retrain(
        SMALL, pretrain_epochs=2, retrain_epochs=1, theta=0.05, device="cpu")
    assert retrain_cfg.model.delta and retrain_cfg.model.theta == 0.05
    assert retrain_cfg.cbtd_delta_alpha == 1.0
    assert pre.steps == 20 and post.steps == 10
    assert np.isfinite(post.final_loss)
    stats = ttrainer.measure_delta_stats(post.params, retrain_cfg,
                                         SpeechDataset(SMALL.data, 4),
                                         n_batches=1)
    assert 0.0 <= stats["layer0"]["temporal_sparsity"] <= 1.0
    # hidden-state deltas show some sparsity even at small theta
    assert stats["layer1"]["temporal_sparsity_dh"] > 0.05
    assert stats["layer1"]["dh_masks"].shape == (4 * 48, 32)
    with pytest.raises(ValueError, match="DeltaLSTM"):
        ttrainer.measure_delta_stats(pre.params, SMALL,
                                     SpeechDataset(SMALL.data, 4))


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["deterministic", "stochastic_cbtd"])
def test_checkpoint_roundtrip_and_resume(tmp_path, stochastic):
    cfg = dataclasses.replace(SMALL, ckpt_dir=str(tmp_path / "ck"),
                              ckpt_every=5, cbtd_stochastic=stochastic)
    full = ttrainer.train(cfg, epochs=2, resume=False, device="cpu")
    # preemption: run 1 epoch (10 steps), stop, resume to 2 epochs
    cfg2 = dataclasses.replace(cfg, ckpt_dir=str(tmp_path / "ck2"))
    ttrainer.train(cfg2, epochs=1, resume=False, device="cpu")
    resumed = ttrainer.train(cfg2, epochs=2, resume=True, device="cpu")
    assert resumed.steps == 20 and len(resumed.losses) == 10
    want, got = _leaves_np(full.params), _leaves_np(resumed.params)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    assert int(resumed.opt_state.step) == 20
    assert CheckpointManager(cfg.ckpt_dir).all_steps() == [15, 20]


def test_checkpoint_manager_async_retention_and_template(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, keep_period=4,
                            async_save=True)
    tree = (
        {"w": torch.arange(4.0), "lstm": [{"b": torch.ones(2, 3)}]},
        topt.AdamState(step=torch.tensor(3, dtype=torch.int32),
                       m={"w": torch.zeros(4)}, v={"w": torch.ones(4)}))
    for s in range(1, 10):
        mgr.save(s, tree, {"data_step": s})
        tree[0]["w"].add_(1.0)     # saves hold host copies taken at save()
    mgr.wait()
    # the newest two plus every multiple of keep_period
    assert mgr.all_steps() == [4, 8, 9]
    os.makedirs(tmp_path / "step_000000011")       # no COMMIT: ignored
    template = (
        {"w": torch.zeros(4, dtype=torch.float64),
         "lstm": [{"b": torch.zeros(2, 3)}]},
        topt.AdamState(step=torch.tensor(0, dtype=torch.int32),
                       m={"w": torch.zeros(4)}, v={"w": torch.zeros(4)}))
    (params, state), meta, step = mgr.restore_latest(template)
    assert step == 9 and meta == {"step": 9, "data_step": 9}
    assert params["w"].dtype == torch.float64
    np.testing.assert_array_equal(params["w"].numpy(), np.arange(4.0) + 8)
    assert isinstance(state, topt.AdamState) and int(state.step) == 3
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(9, ({"w": torch.zeros(5), "lstm": [{"b": torch.zeros(
            2, 3)}]}, template[1]))
    with pytest.raises(KeyError, match="missing leaf"):
        unflatten_into({"nope": torch.zeros(1)}, flatten_tree(tree))
    empty = CheckpointManager(str(tmp_path / "none"))
    assert empty.restore_latest(template) == (template, {}, None)


# -- the launcher's synchronous mode ---------------------------------------------


@pytest.mark.parametrize("pool", [4, 0], ids=["pool", "batch1"])
def test_launcher_synchronous_mode_on_cpu(capsys, pool):
    tlaunch.main(["--spartus", "--device", "cpu", "--hidden", "16",
                  "--requests", "4", "--pool", str(pool),
                  "--chunk-frames", "16"])
    out = capsys.readouterr().out
    assert "trained 30+15 steps" in out
    assert "pack overflow" in out and "modelled Spartus latency" in out
    if pool:
        assert "pool(4, chunked x16): 4 sessions" in out
    else:
        assert "streamed 64 frames" in out
