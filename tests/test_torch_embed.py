"""The port's embedding trainer (trackmpnn_tpu_torch/train/embed.py) and
losses (losses/embedding.py) against the JAX package's, with the same
weights carried across and the same inputs.

One EmbedTrainer step at input_hw (32, 64), max_dets 32, on a chunk of 3
PNG frames (the frame axis cycled to 4) with 36 detections (the capacity
doubled to 64), some of them false positives, for espv2, for dla34 with
dcn_max_offset 2.0 (DCN offset convs perturbed: fractional offsets, some
beyond the bound), and for espv2 with train_bn and JAX's own dropout keep
masks.  Tolerances:
  * packed arrays exact; loss rtol 1e-5; features rtol 1e-4, atol 1e-4 x
    the largest |feature| (DLA-34's sums in another order);
  * Adam's first moments, 0.1 x (grad + L2 * param), rtol 1e-3, atol 1e-4
    x the tensor's largest (the gradient check);
  * the parameters after the step: Adam's first update is +-lr where the
    gradient is well above its rounding, so within 1e-2 x lr wherever the
    first moment exceeds 1e-4 x its tensor's largest, and within 2 lr (a
    sign that rounding can flip) elsewhere;
  * BN buffers: unchanged with frozen BN, rtol 1e-4 of JAX's momentum
    update with train_bn.
The JAX trainer's own initialisation (op-by-op, ~20 s) is replaced by the
carried weights; each JAX step is jitted once and shared by the tests.
"""

import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import backbone_params
from trackmpnn_tpu.backbones import dla as JD
from trackmpnn_tpu.backbones import espnetv2 as JE
from trackmpnn_tpu.losses import embedding as jax_losses
from trackmpnn_tpu.train import embed as jax_embed
from trackmpnn_tpu_torch.backbones import weights as bw
from trackmpnn_tpu_torch.losses import embedding as losses
from trackmpnn_tpu_torch.train import embed

torch.set_num_threads(1)

HW = (32, 64)
MAX_DETS = 32
CLASSES = 128
CONFIGS = {"espv2": dict(arch="espv2"),
           "dla34": dict(arch="dla34", dcn_max_offset=2.0),
           "espv2_train_bn": dict(arch="espv2", train_bn=True)}


def write_chunk(root, down_ratio, seed, frames=3, dets=12):
    """`frames` PNGs (40 x 70, resized by load_image), every other one
    flipped, and `dets` centres a frame in feature-map coordinates."""
    import PIL.Image

    rng = np.random.default_rng(seed)
    fh, fw = HW[0] // down_ratio, HW[1] // down_ratio
    images, centers = [], []
    for t in range(frames):
        path = str(root / f"{t:06d}.png")
        PIL.Image.fromarray(rng.integers(0, 256, (40, 70, 3), dtype=np.uint8)).save(path)
        images.append((path, t % 2 == 1))
        centers.append((rng.integers(0, fh, dets), rng.integers(0, fw, dets)))
    track_ids = rng.integers(-1, 40, frames * dets).astype(np.int32)
    return {"images": images, "centers": centers}, track_ids


def jax_trainer(params_np, **kw):
    """The JAX EmbedTrainer starting from `params_np` instead of its own
    initialisation."""
    pj = {k: jnp.asarray(v) for k, v in params_np.items()}
    with mock.patch.object(JE, "init_espnetv2_seg", lambda *a, **k: pj), \
            mock.patch.object(JD, "init_dlaseg", lambda *a, **k: pj):
        return jax_embed.EmbedTrainer(input_hw=HW, max_dets=MAX_DETS, seed=0, **kw)


def adam_mu(opt_state):
    """scale_by_adam's first moments in the JAX trainer's optax state
    (inject_hyperparams(masked(chain(add_decayed_weights, scale_by_adam,
    scale)))), the BN buffers' masked-out entries dropped."""
    mu = opt_state.inner_state.inner_state[1].mu
    return {k: np.asarray(v) for k, v in mu.items() if isinstance(v, jax.Array)}


def run_case(name, root):
    cfg = CONFIGS[name]
    seed = list(CONFIGS).index(name)
    p0 = backbone_params(cfg["arch"], seed, CLASSES, dcn_max_offset=cfg.get("dcn_max_offset"))
    jt = jax_trainer(p0, **cfg)
    vis_meta, track_ids = write_chunk(root, jt.down_ratio, seed)
    packed = jt._pack(vis_meta)
    images, fr_of, cy, cx, valid, n = packed
    tids = np.full(len(valid), -1, np.int32)
    tids[:n] = track_ids[:n]
    key = jax.random.key(100 + seed)
    params, opt_state, loss, feats = jt._step(jt.params, jt.opt_state, *map(
        jnp.asarray, (images, fr_of, cy, cx, tids, valid)), key)
    mu = adam_mu(opt_state)

    tt = embed.EmbedTrainer(input_hw=HW, max_dets=MAX_DETS, device="cpu", **cfg)
    tt.net.load_state_dict(bw.state_dict_from_jax(p0, tt.net.state_dict()))
    port = {"pack": tt._pack(vis_meta), "infer": tt.infer_chunk(vis_meta)}
    if cfg.get("train_bn"):
        # JAX's own keep masks (espnetv2.py:196-208), [T, 1, 1, C] -> [T, C]
        shapes = tt.net.drop_shapes(len(images))
        keys = (key, jax.random.fold_in(key, 1))
        keep = [torch.from_numpy(np.array(jax.random.bernoulli(k, 0.8, (s[0], 1, 1, s[1]))
                                          [:, 0, 0])) for k, s in zip(keys, shapes)]
        loss_t, feats_t = tt.step(images, fr_of, cy, cx, tids, valid, keep=keep)
        port["loss"], port["feats"] = float(loss_t), feats_t[:n].numpy()
    else:
        port["feats"], port["loss"] = tt.train_chunk(vis_meta, track_ids)
    named = dict(tt.net.named_parameters())
    port["mu"] = bw.state_dict_to_jax({k: tt.opt.state[q]["exp_avg"] for k, q in named.items()})
    port["after"] = bw.backbone_to_jax_params(tt.net)
    return {"p0": p0, "packed": packed, "n": n, "loss": float(loss),
            "feats": np.asarray(feats)[:n], "mu": mu, "after": {k: np.asarray(v)
                                                                for k, v in params.items()},
            "lr": tt.opt.param_groups[0]["lr"], "port": port, "cfg": cfg}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_case(name, tmp_path_factory.mktemp(name))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pack_matches_jax(cases, name):
    """Frames cycled to a multiple of 4, capacity 32 doubled to 64."""
    c = cases(name)
    want, got = c["packed"], c["port"]["pack"]
    assert got[0].shape[0] == 4 and len(got[4]) == 64 and got[5] == c["n"] == 36
    np.testing.assert_array_equal(got[0][3], got[0][0])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_features_match_jax(cases, name):
    c = cases(name)
    assert abs(c["port"]["loss"] - c["loss"]) <= 1e-5 * abs(c["loss"])
    scale = float(np.abs(c["feats"]).max())
    np.testing.assert_allclose(c["port"]["feats"], c["feats"], rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("name", ["espv2", "dla34"])
def test_infer_chunk_matches_jax(cases, name):
    """With frozen BN the step's features are the forward's before the
    update: infer_chunk on the same weights gives them."""
    c = cases(name)
    scale = float(np.abs(c["feats"]).max())
    np.testing.assert_allclose(c["port"]["infer"], c["feats"], rtol=1e-4, atol=1e-4 * scale)


def check_adam_step(p0, lr, mu, mu_ref, after, after_ref):
    """One Adam step against a reference: the first moments (the gradients)
    within rtol 1e-3, atol 1e-4 x each tensor's largest; the parameters
    within 1e-2 x lr where the first moment exceeds 1e-4 x its tensor's
    largest (its sign then holds: the moments agree to ~2e-6 x it), within
    2 lr elsewhere."""
    assert set(mu) == set(mu_ref) and not any(".running_" in k for k in mu)
    sure = total = 0
    for k, m in mu_ref.items():
        scale = float(np.abs(m).max())
        np.testing.assert_allclose(mu[k], m, rtol=1e-3, atol=1e-4 * scale, err_msg=k)
        d = np.abs(after[k] - after_ref[k])
        assert np.all(d <= 2.01 * lr), k
        big = np.abs(m) > 1e-4 * scale
        assert np.all(d[big] <= 1e-2 * lr), k
        assert np.all(np.abs(after_ref[k] - p0[k]) <= 1.01 * lr), k
        sure, total = sure + int(big.sum()), total + m.size
    assert sure > total // 4


@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_adam_step_matches_optax(cases, name):
    c = cases(name)
    check_adam_step(c["p0"], c["lr"], c["port"]["mu"], c["mu"], c["port"]["after"], c["after"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bn_buffers(cases, name):
    """Frozen BN leaves the running statistics alone; train_bn folds the
    batch statistics in with momentum 0.1, as the JAX step does."""
    c = cases(name)
    keys = [k for k in c["p0"] if ".running_" in k]
    assert keys
    for k in keys:
        if c["cfg"].get("train_bn"):
            assert not np.array_equal(c["after"][k], c["p0"][k]), k
            np.testing.assert_allclose(c["port"]["after"][k], c["after"][k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(c["port"]["after"][k], c["p0"][k])
            np.testing.assert_array_equal(c["after"][k], c["p0"][k])


# --------------------------------------------------------------- losses ----
def loss_inputs(seed, n=40, c=16):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, c)).astype(np.float32)
    tids = rng.integers(0, 6, n).astype(np.int32)
    tids[::7] = -1
    return feats, tids, np.arange(n) < n - 5


@pytest.mark.parametrize("loss", ["fairmot", "discriminative"])
def test_embedding_losses_and_grads_match_jax(loss):
    """Value rtol 1e-5, gradient rtol 1e-4 / atol 1e-6 (every cluster has
    several members, so no norm is taken at 0)."""
    feats, tids, valid = loss_inputs(0)
    jfn = {"fairmot": lambda f: jax_losses.fairmot_id_loss(f, tids, valid, 16),
           "discriminative": lambda f: jax_losses.discriminative_embedding_loss(
               f, tids, valid, 8, delta_dist=3.0)}[loss]
    tfn = {"fairmot": lambda f: losses.fairmot_id_loss(f, torch.from_numpy(tids),
                                                       torch.from_numpy(valid), 16),
           "discriminative": lambda f: losses.discriminative_embedding_loss(
               f, torch.from_numpy(tids), torch.from_numpy(valid), 8, delta_dist=3.0)}[loss]
    want, grad = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    got = tfn(f)
    got.backward()
    assert float(want) > 0 and abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(grad), rtol=1e-4, atol=1e-6)


def test_fairmot_loss_counts_no_false_positive_or_padding():
    feats, tids, valid = loss_inputs(1)
    tids[:] = -1
    f = torch.from_numpy(feats)
    none = losses.fairmot_id_loss(f, torch.from_numpy(tids), torch.from_numpy(valid), 16)
    assert float(none) == 0.0


# ------------------------------------------------------- trainer surface ----
@pytest.mark.parametrize("arch", ["espv2", "dla34"])
def test_pack_refuses_centres_outside_the_feature_map(tmp_path, arch):
    tt = embed.EmbedTrainer(arch=arch, input_hw=HW, max_dets=MAX_DETS, device="cpu")
    vis_meta, _ = write_chunk(tmp_path, 1, 0, frames=1, dets=3)  # input-pixel coordinates
    vis_meta["centers"][0][0][0] = HW[0]
    match = f"exceed the {HW[0] // tt.down_ratio}x{HW[1] // tt.down_ratio} feature map"
    with pytest.raises(ValueError, match=match):
        tt._pack(vis_meta)
    with pytest.raises(ValueError, match=match):
        jax_embed.EmbedTrainer._pack(tt, vis_meta)


def test_load_image_matches_jax_and_reads_unreadable_files_as_zeros(tmp_path):
    vis_meta, _ = write_chunk(tmp_path, 1, 3, frames=1, dets=1)
    path = vis_meta["images"][0][0]
    for flip in (False, True):
        np.testing.assert_array_equal(embed.load_image(path, flip, HW),
                                      jax_embed.load_image(path, flip, HW))
    bad = tmp_path / "placeholder.png"
    bad.write_bytes(b"not an image")
    got = embed.load_image(str(bad), False, HW)
    np.testing.assert_array_equal(got, jax_embed.load_image(str(bad), False, HW))
    np.testing.assert_allclose(got[0, 0], -embed.IMAGENET_MEAN / embed.IMAGENET_STD)


def test_load_image_raises_without_pil(tmp_path, monkeypatch):
    """A difference by design: the JAX loader turns a missing PIL into zero
    frames; the port raises."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        embed.load_image(str(tmp_path / "x.png"), False, HW)
    np.testing.assert_allclose(jax_embed.load_image(str(tmp_path / "x.png"), False, HW)[0, 0],
                               -embed.IMAGENET_MEAN / embed.IMAGENET_STD)


def test_trainer_options():
    with pytest.raises(NotImplementedError, match="bf16 rectangles"):
        embed.EmbedTrainer(conv_dtype="bfloat16", input_hw=HW, device="cpu")
    with pytest.raises(ValueError, match="incompatible with train_bn"):
        embed.EmbedTrainer(train_bn=True, frame_chunk=1, input_hw=HW, device="cpu")
    with pytest.raises(ValueError, match="unknown embed arch"):
        embed.EmbedTrainer(arch="resnet", input_hw=HW, device="cpu")
    # "auto" never chunks under train_bn, as in the JAX trainer
    embed.EmbedTrainer(train_bn=True, frame_chunk="auto", input_hw=HW, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            embed.EmbedTrainer(input_hw=HW)


def test_frame_chunks_change_no_number(tmp_path, monkeypatch):
    """frame_chunk=1 against the whole chunk: the same loss, features and
    weights after the step (the port trains a chunk whole); and infer over a
    10-frame chunk (cycled to 12) the same, rtol 1e-5 / atol 1e-5 x the
    largest, in backbone calls of 1, INFER_FRAMES and all 12 frames."""
    vis_meta, tids = write_chunk(tmp_path, 1, 4)
    runs = []
    for fc in (None, 1):
        tt = embed.EmbedTrainer(input_hw=HW, max_dets=MAX_DETS, device="cpu", frame_chunk=fc)
        feats, loss = tt.train_chunk(vis_meta, tids)
        runs.append((loss, feats, bw.backbone_to_jax_params(tt.net)))
    (l0, f0, a0), (l1, f1, a1) = runs
    assert l0 == l1
    np.testing.assert_array_equal(f1, f0)
    for k in a0:
        np.testing.assert_array_equal(a1[k], a0[k], err_msg=k)

    long_meta, _ = write_chunk(tmp_path, 1, 5, frames=10, dets=4)
    got = {}
    for frames in (1, embed.INFER_FRAMES, 12):
        monkeypatch.setattr(embed, "INFER_FRAMES", frames)
        got[frames] = tt.infer_chunk(long_meta)
    want = got.pop(12)
    assert want.shape == (40, CLASSES)
    for frames, f in got.items():
        np.testing.assert_allclose(f, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"{frames} frames a call")


def test_trainer_runs_in_full_f32_and_restores_the_flags(tmp_path, monkeypatch):
    """PyTorch lets cuDNN convolve in TF32 by default: the step's forward and
    backward and infer's forward see TF32 off for cuDNN and cuBLAS, and the
    caller's flags come back afterwards."""
    flags = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []

    def hook(module, args, out):
        seen.append(("forward",) + flags())
        if out.requires_grad:
            out.register_hook(lambda g: seen.append(("backward",) + flags()))

    tt = embed.EmbedTrainer(input_hw=HW, max_dets=MAX_DETS, device="cpu")
    tt.net.register_forward_hook(hook)
    vis_meta, tids = write_chunk(tmp_path, 1, 6)
    tt.train_chunk(vis_meta, tids)
    tt.infer_chunk(vis_meta)
    assert seen == [("forward", False, False), ("backward", False, False),
                    ("forward", False, False)]
    assert flags() == (True, True)


def test_normalized_vis_features_match_jax():
    feats = loss_inputs(2)[0]
    np.testing.assert_allclose(embed.normalized_vis_features(feats),
                               jax_embed.normalized_vis_features(feats), rtol=1e-6, atol=1e-6)
