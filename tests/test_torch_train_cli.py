"""The port's training CLI, full-state checkpoints and ablation CLI against
the JAX package's, on the CPU.

* Checkpoints: a JAX full train state (params, BN stats, optax's Adam state,
  epoch, best MOTA) resumes in the port and the port's in JAX, and the next
  Adam step from either agrees (rtol 1e-5: one f32 update in another
  order).
* The CLI: one small run of each CLI from the same JAX --snapshot (21
  sequences of 6 frames, --feats 2d, nhidden 16, 1 epoch, no random
  transforms), shared by a module-scoped fixture.  The per-epoch losses
  agree within rtol 1e-4 (the port's history) and to the logs' printed
  digits; val F1, MOTA and mAP are equal (the same decoded tracks).
* --msg-type concat through both training CLIs and the ablation CLI.
* The output-dir refusal, the routing of --batch-windows and TM_PACKED, and
  the refusals of the flags whose paths are not ported.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import spread_weights
from trackmpnn_tpu.cli import ablation as jablation
from trackmpnn_tpu.cli import train as jtrain
from trackmpnn_tpu.models import mpnn as jmpnn
from trackmpnn_tpu.train import checkpoint as jcheckpoint
from trackmpnn_tpu.train import optim as joptim
from trackmpnn_tpu_torch.cli import ablation, train
from trackmpnn_tpu_torch.data.synthetic import write_kitti_tree
from trackmpnn_tpu_torch.models import mpnn, weights
from trackmpnn_tpu_torch.train import checkpoint, optim
from trackmpnn_tpu_torch.train.block import param_leaves, trainable
from trackmpnn_tpu_torch.train.embed import EmbedTrainer

torch.set_num_threads(1)

CFG = mpnn.ModelConfig(features="2d+temp", nhidden=8)


def jax_state(seed, steps):
    """A JAX full train state after `steps` optax updates with seeded
    gradients, and the next step's gradient."""
    p_np, s_np = spread_weights(CFG, seed)
    params = jax.tree_util.tree_map(jnp.asarray, p_np)
    tx = joptim.make_optimizer(1e-3, 5e-4)
    st = tx.init(params)
    rng = np.random.default_rng(seed)
    grad = lambda: jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), params)
    for _ in range(steps):
        upd, st = tx.update(grad(), st, params)
        params = jax.tree_util.tree_map(lambda a, b: a + b, params, upd)
    return tx, {"params": params, "batch_stats": s_np, "opt_state": st, "epoch": 3,
                "best_mota": 41.5}, grad()


def jax_step(tx, state, g):
    upd, st = tx.update(g, state["opt_state"], state["params"])
    return jax.tree_util.tree_map(lambda a, b: a + b, state["params"], upd), st


def port_step(params, opt, g):
    for leaf, gl in zip(param_leaves(params), param_leaves(weights.map_shaped(
            lambda x, s, p: torch.tensor(np.asarray(x)), g, weights.param_shapes(CFG)))):
        leaf.grad = gl
    opt.step()


def assert_params_close(port_params, jax_params, rtol=1e-5):
    got = weights.map_shaped(lambda t, shape, path: t.detach().numpy(), port_params,
                             weights.param_shapes(CFG))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jax_params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=1e-7)


def test_jax_state_resumes_in_port_and_back(tmp_path):
    tx, state, g = jax_state(seed=4, steps=3)
    path = str(tmp_path / "track-mpnn_0003.npz")
    jcheckpoint.save(path, state)

    params, stats, epoch, best = checkpoint.load_state(path, CFG)
    assert (epoch, best) == (3, 41.5)
    params = trainable(params)
    opt = optim.make_optimizer(param_leaves(params), 1.0, 0.0)
    checkpoint.load_optimizer_state(path, opt, params, CFG)
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-3) and \
        opt.param_groups[0]["weight_decay"] == pytest.approx(5e-4)
    for leaf, mu in zip(param_leaves(params), jax.tree_util.tree_leaves(state["opt_state"]
                                                                        .inner_state[1].mu)):
        st = opt.state[leaf]
        assert int(st["step"]) == 3
        np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(mu))
    # the next step from the resumed state agrees with optax's
    port_step(params, opt, g)
    want_params, want_st = jax_step(tx, state, g)
    assert_params_close(params, want_params)

    # and the port's state resumes in JAX
    back = str(tmp_path / "track-mpnn_0004.npz")
    checkpoint.save_state(back, params, stats, opt, CFG, 4, 50.0)
    like = {"params": state["params"], "batch_stats": state["batch_stats"],
            "opt_state": tx.init(state["params"]), "epoch": 0, "best_mota": 0.0}
    loaded = jcheckpoint.load(back, like)
    assert loaded["epoch"] == 4 and loaded["best_mota"] == 50.0
    assert int(loaded["opt_state"].count) == int(want_st.count) == 4
    for a, b in zip(jax.tree_util.tree_leaves(loaded["opt_state"].inner_state[1].nu),
                    jax.tree_util.tree_leaves(want_st.inner_state[1].nu)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-12)
    _, g2 = jax_state(seed=9, steps=0)[1:]
    port_step(params, opt, g2)
    resumed, _ = jax_step(tx, loaded, g2)
    assert_params_close(params, resumed)


def test_embed_adam_state_round_trips(tmp_path):
    """save_embed then load_embed restores the net and its Adam state."""
    kw = dict(arch="espv2", num_vis_feats=8, input_hw=(32, 64), seed=3, device="cpu")
    tr = EmbedTrainer(**kw)
    rng = np.random.default_rng(0)
    tr.step(rng.normal(size=(4, 32, 64, 3)).astype(np.float32), np.array([0, 1, 2, 3]),
            np.array([3, 4, 5, 6]), np.array([7, 8, 9, 10]), np.array([1, 2, 1, 2]),
            np.ones(4, bool))
    path = str(tmp_path / "vis-net_0001.npz")
    checkpoint.save_embed(path, tr)
    tr2 = EmbedTrainer(**dict(kw, seed=4))
    checkpoint.load_embed(path, tr2)
    for (name, p), (_, q) in zip(tr.net.named_parameters(), tr2.net.named_parameters()):
        assert torch.equal(p, q), name
        a, b = tr.opt.state[p], tr2.opt.state[q]
        assert int(a["step"]) == int(b["step"]) == 1
        assert torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"],
                                                                        b["exp_avg_sq"])


# ------------------------------------------------------------------ the CLI ----
COMMON = ["--category", "All", "--detections", "rrc", "--feats", "2d", "--cur-win-size", "4",
          "--epochs", "1", "--num-hidden-feats", "16"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("train_cli")
    root = str(base / "kitti")
    write_kitti_tree(root, num_seqs=21, num_frames=6, num_tracks=4, seed=0)
    jcfg = jmpnn.ModelConfig(features="2d", nhidden=16)
    p = jmpnn.init_params(jax.random.key(3), jcfg)
    snap = str(base / "snap" / "track-mpnn_0000.npz")
    jcheckpoint.save(snap, {"params": p, "batch_stats": jmpnn.init_batch_stats(jcfg),
                            "opt_state": joptim.make_optimizer().init(p), "epoch": 0,
                            "best_mota": -1e3})
    args = ["--dataset-root-path", root, "--snapshot", snap] + COMMON
    out = {"root": root, "snap": snap, "base": base}
    out["jax"] = (jtrain.main(args + ["--output-dir", str(base / "jax")]), str(base / "jax"))
    out["port"] = (train.main(args + ["--output-dir", str(base / "port"), "--device", "cpu"]),
                   str(base / "port"))
    return out


NUM = r"(-?[0-9.]+)"
LOG_KEYS = {"loss_c": r"Average cross-entropy loss for epoch = " + NUM,
            "loss_f": r"Average focal loss for epoch = " + NUM,
            "loss": r"Average loss for epoch = " + NUM,
            "train_f1": r"Average F1 score for epoch = " + NUM,
            "val_f1": r"Validation F1 score = " + NUM,
            "val_mota": r"Validation MOTA = " + NUM + "%",
            "val_map": r"Validation mAP = " + NUM + "%"}


def parse_log(out_dir):
    text = open(os.path.join(out_dir, "logs.txt")).read()
    return {k: [float(x) for x in re.findall(p, text)] for k, p in LOG_KEYS.items()}, text


def test_train_cli_matches_jax(runs):
    (jh, jdir), (th, tdir) = runs["jax"], runs["port"]
    for k in ("loss_c", "loss_f", "loss", "train_f1"):
        np.testing.assert_allclose(th[k], jh[k], rtol=1e-4, err_msg=k)
    for k in ("val_f1", "val_mota", "val_map"):
        assert th[k] == jh[k], k
    jl, _ = parse_log(jdir)
    tl, text = parse_log(tdir)
    for k in LOG_KEYS:
        assert len(tl[k]) == len(jl[k]) == 1, k
        np.testing.assert_allclose(tl[k], jl[k], rtol=0, atol=0.011, err_msg=k)
    assert "Validation MOTA for sequence 2" in text and "resumed from" in text
    for name in ("track-mpnn_best.npz", "track-mpnn_0001.npz", "config.json"):
        assert os.path.exists(os.path.join(tdir, name))
    # the port's best checkpoint is a full state the JAX package loads
    jcfg = jmpnn.ModelConfig(features="2d", nhidden=16)
    p = jmpnn.init_params(jax.random.key(0), jcfg)
    loaded = jcheckpoint.load(os.path.join(tdir, "track-mpnn_best.npz"), {
        "params": p, "batch_stats": jmpnn.init_batch_stats(jcfg),
        "opt_state": joptim.make_optimizer().init(p), "epoch": 0, "best_mota": 0.0})
    assert loaded["epoch"] == 1 and loaded["best_mota"] == pytest.approx(th["val_mota"][0])
    assert json.load(open(os.path.join(tdir, "config.json")))["device"] == "cpu"


def test_ablation_cli_matches_jax(runs):
    snap = os.path.join(runs["port"][1], "track-mpnn_best.npz")
    args = ["--snapshot", snap, "--dataset-root-path", runs["root"]]
    want = jablation.main(args + ["--output-dir", str(runs["base"] / "jabl")])
    got = ablation.main(args + ["--output-dir", str(runs["base"] / "tabl"), "--device", "cpu"])
    assert got == want and got["num_unique_objects"] > 0


def test_resume_and_output_dir_refusal(runs):
    best = os.path.join(runs["port"][1], "track-mpnn_best.npz")
    out = str(runs["base"] / "resumed")
    hist = train.main(["--dataset-root-path", runs["root"], "--snapshot", best,
                       "--output-dir", out, "--device", "cpu"] + COMMON[:-4]
                      + ["--epochs", "2", "--num-hidden-feats", "16"])
    assert len(hist["loss"]) == 1
    assert "at epoch 2" in open(os.path.join(out, "logs.txt")).read()
    with pytest.raises(FileExistsError, match="output directory exists"):
        train.main(["--dataset-root-path", runs["root"], "--output-dir", out,
                    "--device", "cpu"] + COMMON)


@pytest.mark.parametrize("env,flags,log", [
    ({}, ["--batch-windows", "2", "--no-bf16"], "block-structured batched training: 2"),
    ({}, ["--batch-windows", "2"], "block-structured batched training: 2 windows/step (bf16)"),
    ({"TM_PACKED": "1"}, ["--batch-windows", "2"], "packed batched training: 2"),
    ({}, ["--batch-windows", "2", "--no-bf16", "--msg-type", "concat"],
     "block-structured batched training: 2")])
def test_routing(runs, monkeypatch, env, flags, log):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = str(runs["base"] / ("route_" + "_".join(env) + "_".join(flags[2:])))
    hist = train.main(["--dataset-root-path", runs["root"], "--output-dir", out,
                       "--device", "cpu"] + COMMON + flags)
    assert log in open(os.path.join(out, "logs.txt")).read()
    assert np.isfinite(hist["loss"][0]) and hist["steps"][0] > 0


def test_gat_dropout_stream_is_seeded_by_the_seed(runs):
    """With attention heads the port draws its dropout masks from a
    torch.Generator seeded by --seed (the JAX CLI folds its keys, another
    stream by design): two runs with one seed train alike."""
    hist = []
    for k in range(2):
        hist.append(train.main(["--dataset-root-path", runs["root"], "--device", "cpu",
                                "--output-dir", str(runs["base"] / f"gat_{k}"),
                                "--num-att-heads", "1"] + COMMON))
    assert hist[0]["loss"] == hist[1]["loss"] and np.isfinite(hist[0]["loss"][0])


def test_msg_concat_cli_matches_jax(runs):
    """--msg-type concat: one epoch of both training CLIs from one JAX
    concat snapshot on the fixture's tree; losses within rtol 1e-4 and val
    F1, MOTA and mAP equal, as test_train_cli_matches_jax holds them; the
    ablation CLI reads the run's options and serves the port's best
    checkpoint as JAX's does."""
    jcfg = jmpnn.ModelConfig(features="2d", nhidden=16, msg_type="concat")
    p = jmpnn.init_params(jax.random.key(4), jcfg)
    snap = str(runs["base"] / "snap_concat" / "track-mpnn_0000.npz")
    jcheckpoint.save(snap, {"params": p, "batch_stats": jmpnn.init_batch_stats(jcfg),
                            "opt_state": joptim.make_optimizer().init(p), "epoch": 0,
                            "best_mota": -1e3})
    args = ["--dataset-root-path", runs["root"], "--snapshot", snap, "--msg-type",
            "concat"] + COMMON
    jh = jtrain.main(args + ["--output-dir", str(runs["base"] / "jax_concat")])
    tdir = str(runs["base"] / "port_concat")
    th = train.main(args + ["--output-dir", tdir, "--device", "cpu"])
    for k in ("loss_c", "loss_f", "loss", "train_f1"):
        np.testing.assert_allclose(th[k], jh[k], rtol=1e-4, err_msg=k)
    for k in ("val_f1", "val_mota", "val_map"):
        assert th[k] == jh[k], k
    assert json.load(open(os.path.join(tdir, "config.json")))["msg_type"] == "concat"
    best = ["--snapshot", os.path.join(tdir, "track-mpnn_best.npz"), "--dataset-root-path",
            runs["root"]]
    want = jablation.main(best + ["--output-dir", str(runs["base"] / "jabl_concat")])
    got = ablation.main(best + ["--output-dir", str(runs["base"] / "tabl_concat"),
                                "--device", "cpu"])
    assert got == want and got["num_unique_objects"] > 0


@pytest.mark.parametrize("flags,item", [
    (["--batch-windows", "2", "--embed-bf16"], "'bf16 rectangles'"),
    (["--embed-bf16"], "'bf16 rectangles'"),
    (["--mesh", "data=2"], "'Multi-GPU'"),
    (["--dataset", "bdd100k", "--category", "car", "--detections", "libra"], "'BDD100K data'"),
    (["--plot-gradients"], "'Tail'")])
def test_refusals_name_their_item(tmp_path, flags, item):
    out = str(tmp_path / "refused")
    argv = ["--dataset-root-path", str(tmp_path), "--output-dir", out, "--device", "cpu"]
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        train.main(argv + [a for a in COMMON if a not in ("All", "rrc", "--category",
                                                          "--detections")] + flags)
    assert not os.path.exists(out)


def test_entry_points_default_to_the_card(runs, tmp_path):
    """Without --device the CLIs and the batched tracker ask for the card,
    and raise where there is none rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal only shows without one")
    from trackmpnn_tpu_torch.decode import BatchedTracker, TrackerConfig

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--dataset-root-path", runs["root"], "--output-dir",
                    str(tmp_path / "t")] + COMMON)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ablation.main(["--snapshot", os.path.join(runs["port"][1], "track-mpnn_best.npz"),
                       "--dataset-root-path", runs["root"], "--output-dir", str(tmp_path / "a")])
    cfg = mpnn.ModelConfig(nhidden=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchedTracker(mpnn.init_params(torch.Generator().manual_seed(0), cfg),
                       mpnn.init_batch_stats(cfg), cfg, TrackerConfig())
