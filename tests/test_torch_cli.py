"""The port's inference CLI and checkpoint formats against the JAX
package's: one JAX-format snapshot serves in both CLIs and they must write
identical KITTI result files, with the 2d features and with the default
2d+temp+vis (its vis-net snapshot beside the tracker's); tracker and
vis-net snapshots cross between the packages bit-exactly."""

import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import backbone_params, spread_weights
from trackmpnn_tpu.backbones import espnetv2 as JE
from trackmpnn_tpu.cli import infer as jinfer
from trackmpnn_tpu.cli import train as jtrain
from trackmpnn_tpu.models import mpnn as jmpnn
from trackmpnn_tpu.train import checkpoint as jcheckpoint
from trackmpnn_tpu.train import embed as jembed
from trackmpnn_tpu_torch.backbones import weights as bw
from trackmpnn_tpu_torch.cli import infer as tinfer
from trackmpnn_tpu_torch.cli import train as ttrain
from trackmpnn_tpu_torch.data.synthetic import write_kitti_tree
from trackmpnn_tpu_torch.models import mpnn, weights
from trackmpnn_tpu_torch.train import checkpoint
from trackmpnn_tpu_torch.train.embed import EmbedTrainer

torch.set_num_threads(1)

CFG = mpnn.ModelConfig(features="2d", ncategories=3, nhidden=16, msg_type="diff")
TRAIN_CONFIG = {"dataset": "kitti", "category": "All", "detections": "rrc",
                "feats": "2d", "embed_arch": "espv2", "cur_win_size": 5,
                "ret_win_size": 0, "no_tp_classifier": False,
                "num_hidden_feats": 16, "num_att_heads": 0, "msg_type": "diff"}


def jax_like():
    jcfg = jmpnn.ModelConfig(features="2d", ncategories=3, nhidden=16)
    return {"params": jmpnn.init_params(jax.random.key(0), jcfg),
            "batch_stats": jmpnn.init_batch_stats(jcfg), "opt_state": None,
            "epoch": 0, "best_mota": 0.0}


def test_port_snapshot_loads_in_jax(tmp_path):
    p_np, s_np = spread_weights(CFG, seed=1)
    p, s = weights.from_jax_params(p_np, s_np, CFG)
    path = str(tmp_path / "track-mpnn_best.npz")
    checkpoint.save_model(path, p, s, CFG, epoch=3, best_mota=0.5)
    loaded = jcheckpoint.load(path, jax_like())
    assert loaded["epoch"] == 3 and loaded["best_mota"] == 0.5
    for a, b in zip(jax.tree_util.tree_leaves((loaded["params"], loaded["batch_stats"])),
                    jax.tree_util.tree_leaves((p_np, s_np))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_jax_snapshot_loads_in_port(tmp_path):
    p_np, s_np = spread_weights(CFG, seed=2)
    path = str(tmp_path / "track-mpnn_best.npz")
    jcheckpoint.save(path, {"params": p_np, "batch_stats": s_np, "opt_state": None,
                            "epoch": 1, "best_mota": 0.25})
    p, s = checkpoint.load(path, CFG)
    back = weights.to_jax_params(p, s, CFG)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves((p_np, s_np))):
        np.testing.assert_array_equal(a, b)
    del p_np["branches"][0]["node_gru"]["b_hh"]
    jcheckpoint.save(path, {"params": p_np, "batch_stats": s_np})
    with pytest.raises(KeyError, match="node_gru/b_hh"):
        checkpoint.load(path, CFG)


@pytest.mark.parametrize("hungarian", [True, False])
def test_infer_cli_writes_the_jax_cli_result_files(tmp_path, hungarian):
    root = str(tmp_path / "kitti")
    write_kitti_tree(root, num_seqs=2, num_frames=10, num_tracks=6, split_dir="testing", seed=3)
    snap_dir = tmp_path / "snap"
    snap_dir.mkdir()
    snapshot = str(snap_dir / "track-mpnn_best.npz")
    p_np, s_np = spread_weights(CFG, seed=0, std=0.3)
    jcheckpoint.save(snapshot, {"params": p_np, "batch_stats": s_np, "opt_state": None,
                                "epoch": 0, "best_mota": 0.0})
    (snap_dir / "config.json").write_text(json.dumps(TRAIN_CONFIG))

    extra = ["--hungarian"] if hungarian else []
    out_j, out_t = str(tmp_path / "out_jax"), str(tmp_path / "out_torch")
    jinfer.main(["--snapshot", snapshot, "--dataset-root-path", root, "--output-dir", out_j] + extra)
    tinfer.main(["--snapshot", snapshot, "--dataset-root-path", root, "--output-dir", out_t,
                 "--device", "cpu"] + extra)

    files = sorted(f for f in os.listdir(out_j) if f.endswith(".txt"))
    assert files == ["0000.txt", "0001.txt"]
    assert sorted(f for f in os.listdir(out_t) if f.endswith(".txt")) == files
    lines = 0
    for f in files:
        want = open(os.path.join(out_j, f)).read()
        assert open(os.path.join(out_t, f)).read() == want
        lines += len(want.splitlines())
    assert lines > 0
    assert json.load(open(os.path.join(out_t, "config.json")))["device"] == "cpu"


# ------------------------------------------------ the default features: vis ----
VIS_HW = (64, 192)  # the embedding input of these tests, in place of KITTI's 384 x 1280


def jax_embed_trainer(params_np, num_vis_feats=16):
    """The JAX EmbedTrainer (espv2) holding `params_np`, without its
    op-by-op initialisation."""
    pj = {k: jnp.asarray(v) for k, v in params_np.items()}
    with mock.patch.object(JE, "init_espnetv2_seg", lambda *a, **k: pj):
        return jembed.EmbedTrainer(arch="espv2", num_vis_feats=num_vis_feats, input_hw=VIS_HW)


def port_embed_trainer(params_np, num_vis_feats=16):
    tt = EmbedTrainer(arch="espv2", num_vis_feats=num_vis_feats, input_hw=VIS_HW, device="cpu")
    tt.net.load_state_dict(bw.state_dict_from_jax(params_np, tt.net.state_dict()))
    return tt


def test_jax_vis_net_loads_in_port(tmp_path):
    p0 = backbone_params("espv2", 11)
    jt = jax_embed_trainer(p0)
    path = str(tmp_path / "vis-net_best.npz")
    jcheckpoint.save(path, {"params": jt.params, "opt_state": jt.opt_state})
    tt = EmbedTrainer(arch="espv2", num_vis_feats=16, input_hw=VIS_HW, seed=3, device="cpu")
    checkpoint.load_embed(path, tt)
    got = bw.backbone_to_jax_params(tt.net)
    assert set(got) == set(p0)
    for k in p0:
        np.testing.assert_array_equal(got[k], p0[k], err_msg=k)
    # the CLI helper finds it beside the tracker snapshot, and refuses without it
    tt2 = EmbedTrainer(arch="espv2", num_vis_feats=16, input_hw=VIS_HW, seed=4, device="cpu")
    ttrain.load_vis_net(tt2, str(tmp_path / "track-mpnn_best.npz"))
    assert all(np.array_equal(v, p0[k]) for k, v in bw.backbone_to_jax_params(tt2.net).items())
    with pytest.raises(FileNotFoundError, match="vis-net_0007.npz"):
        ttrain.load_vis_net(tt2, str(tmp_path / "track-mpnn_0007.npz"))


def test_port_vis_net_loads_in_jax(tmp_path):
    """After one port train step, the snapshot restores in the JAX CLI's
    load_vis_net: params, Adam's moments and counts, lr and L2."""
    p0 = backbone_params("espv2", 12)
    tt = port_embed_trainer(p0)
    rng = np.random.default_rng(12)
    n, cap = 10, 16
    tids = np.concatenate([rng.integers(0, 4, n), -np.ones(cap - n)]).astype(np.int32)
    tt.step(rng.normal(size=(4, *VIS_HW, 3)).astype(np.float32),
            np.repeat(np.arange(4), 4)[:cap].astype(np.int32),
            rng.integers(0, VIS_HW[0], cap).astype(np.int32),
            rng.integers(0, VIS_HW[1], cap).astype(np.int32), tids, np.arange(cap) < n)
    checkpoint.save_embed(str(tmp_path / "vis-net_best.npz"), tt)
    jt = jax_embed_trainer(backbone_params("espv2", 13))
    jtrain.load_vis_net(jt, str(tmp_path / "track-mpnn_best.npz"))
    want = bw.backbone_to_jax_params(tt.net)
    named = dict(tt.net.named_parameters())
    mu = bw.state_dict_to_jax({k: tt.opt.state[q]["exp_avg"] for k, q in named.items()})
    nu = bw.state_dict_to_jax({k: tt.opt.state[q]["exp_avg_sq"] for k, q in named.items()})
    adam = jt.opt_state.inner_state.inner_state[1]
    assert set(np.asarray(jt.params[k]).shape == want[k].shape for k in want) == {True}
    for k in want:
        np.testing.assert_array_equal(np.asarray(jt.params[k]), want[k], err_msg=k)
    for k in mu:
        np.testing.assert_array_equal(np.asarray(adam.mu[k]), mu[k], err_msg=k)
        np.testing.assert_array_equal(np.asarray(adam.nu[k]), nu[k], err_msg=k)
    assert int(adam.count) == int(jt.opt_state.count) == 1
    hp = jt.opt_state.hyperparams
    assert float(hp["learning_rate"]) == np.float32(5e-4)
    assert float(hp["weight_decay"]) == np.float32(5e-4)


VIS_CFG = mpnn.ModelConfig(features="2d+temp+vis", ncategories=3, nhidden=16)


def test_infer_cli_default_features_writes_the_jax_cli_result_files(tmp_path, monkeypatch):
    """2d+temp+vis with espv2 (the CLIs' defaults), on a tiny tree of real
    PNGs: a port-written tracker and vis-net snapshot serve in both CLIs,
    which must write identical result files."""
    for mod in (jtrain, ttrain):
        monkeypatch.setattr(mod, "default_input_hw", lambda args: VIS_HW)
    root = str(tmp_path / "kitti")
    write_kitti_tree(root, num_seqs=2, num_frames=8, num_tracks=5, split_dir="testing", seed=6,
                     real_images=True)
    snap_dir = tmp_path / "snap"
    snapshot = str(snap_dir / "track-mpnn_best.npz")
    p_np, s_np = spread_weights(VIS_CFG, seed=5, std=0.3)
    checkpoint.save_model(snapshot, *weights.from_jax_params(p_np, s_np, VIS_CFG), VIS_CFG)
    checkpoint.save_embed(str(snap_dir / "vis-net_best.npz"),
                          port_embed_trainer(backbone_params("espv2", 5, num_vis_feats=128),
                                             num_vis_feats=128))
    (snap_dir / "config.json").write_text(json.dumps(
        {**TRAIN_CONFIG, "feats": "2d+temp+vis", "embed_arch": "espv2"}))

    out_j, out_t = str(tmp_path / "out_jax"), str(tmp_path / "out_torch")
    jinfer.main(["--snapshot", snapshot, "--dataset-root-path", root, "--output-dir", out_j,
                 "--hungarian"])
    tinfer.main(["--snapshot", snapshot, "--dataset-root-path", root, "--output-dir", out_t,
                 "--hungarian", "--device", "cpu"])
    files = sorted(f for f in os.listdir(out_j) if f.endswith(".txt"))
    assert files == ["0000.txt", "0001.txt"]
    assert sorted(f for f in os.listdir(out_t) if f.endswith(".txt")) == files
    lines = 0
    for f in files:
        want = open(os.path.join(out_j, f)).read()
        assert open(os.path.join(out_t, f)).read() == want
        lines += len(want.splitlines())
    assert lines > 0
    # without the vis-net snapshot the port refuses, as JAX does
    os.remove(str(snap_dir / "vis-net_best.npz"))
    with pytest.raises(FileNotFoundError, match="vis-net_best.npz"):
        tinfer.main(["--snapshot", snapshot, "--dataset-root-path", root,
                     "--output-dir", str(tmp_path / "out_none"), "--device", "cpu"])
