"""The port's InferenceSession against the JAX package's, on the CPU.

Both sessions serve the same weights (the JAX session's, carried over by
``load_flax_variables``) at 32x64 with 8 planes and k = 5, on the same
``SyntheticScenes`` frames. Tolerances: idepth, prob and depth agree to
2e-4 (relative for depth, whose values reach hundreds where idepth is
small), the f32 summation-order figure of the model tests. The normals
are judged by the f64-oracle rule of ``test_torch_normals`` on the JAX
depth: no worse than the JAX package's normals op. The f16 wire is within f16
resolution (2^-10 relative) of the f32 wire.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cnmnet_tpu.config import Config as JConfig  # noqa: E402
from cnmnet_tpu.data.pipeline import collate as j_collate  # noqa: E402
from cnmnet_tpu.data.synthetic import SyntheticScenes as JScenes  # noqa: E402
from cnmnet_tpu.ops.normals import depth_to_normal as j_depth_to_normal  # noqa: E402
from cnmnet_tpu.serve import InferenceSession as JSession  # noqa: E402
from cnmnet_tpu_torch.config import Config  # noqa: E402
from cnmnet_tpu_torch.data.pipeline import collate, normalize_images, quantize_images_u8  # noqa: E402
from cnmnet_tpu_torch.data.synthetic import SyntheticScenes  # noqa: E402
from cnmnet_tpu_torch.serve import InferenceSession  # noqa: E402
from cnmnet_tpu_torch.geometry.camera import invert_intrinsics  # noqa: E402
from cnmnet_tpu_torch.ops.normals import depth_to_normal  # noqa: E402
from tests.test_torch_normals import no_worse, oracle_f64  # noqa: E402

H, W, K = 32, 64, 5
TOL = 2e-4


def _cfg(cls):
    cfg = cls()
    cfg.model.num_planes = 8
    cfg.model.k_size = K
    return cfg


@pytest.fixture(scope="module")
def frames():
    ds = SyntheticScenes(num_samples=3, height=H, width=W, view_num=3)
    batch = collate([ds[i] for i in range(3)])
    return quantize_images_u8(batch["images"]), batch["cams"].astype(np.float32)


@pytest.fixture(scope="module")
def sessions(frames):
    """(JAX session, port session with the JAX session's weights)."""
    images, cams = frames
    js = JSession(_cfg(JConfig), batch_buckets=(1, 2))
    js.predict(images[:1], cams[:1])  # initialises the JAX weights
    variables = jax.tree_util.tree_map(np.asarray, js._variables)
    ts = InferenceSession(_cfg(Config), flax_variables=variables, batch_buckets=(1, 2),
                          device="cpu")
    return js, ts, variables


def _check(got, want):
    assert set(got) == set(want)
    for name in ("idepth", "prob"):
        if name in want:
            assert got[name].shape == want[name].shape
            assert np.abs(got[name] - want[name]).max() < TOL, name
    if "depth" in want:
        rel = np.abs(got["depth"] - want["depth"]) / np.maximum(np.abs(want["depth"]), 1.0)
        assert rel.max() < TOL


def _normals_no_worse(got, want, cams):
    """On the JAX session's depth, the port's normals op is no worse than
    the JAX package's ``ops.normals.depth_to_normal`` by the f64-oracle
    rule; the port session's normals are that op applied to its own depth.
    (At near-singular pixels an ulp of depth, or XLA fusing the JAX op
    differently inside the session's jit, turns the f32 normal by degrees,
    so the two sessions' normal maps are not compared with each other.)"""
    K_inv = invert_intrinsics(torch.from_numpy(cams[:, 0, 1, :3, :3]))
    truth, det = oracle_f64(want["depth"], K_inv.numpy(), K)
    on_jax_depth, _ = depth_to_normal(torch.from_numpy(want["depth"]), K_inv, K)
    jax_op, _ = j_depth_to_normal(jnp.asarray(want["depth"]), jnp.asarray(K_inv.numpy()), K)
    no_worse(on_jax_depth.numpy(), np.asarray(jax_op), truth, det)
    own, _ = depth_to_normal(torch.from_numpy(got["depth"]), K_inv, K)
    np.testing.assert_array_equal(got["normal"], own.numpy())


def test_uint8_wire_matches_jax(sessions, frames):
    js, ts, _ = sessions
    images, cams = frames
    want = js.predict(images[:1], cams[:1])
    got = ts.predict(images[:1], cams[:1])
    assert got["normal"].shape == (1, H, W, 3) and got["idepth"].dtype == np.float32
    _check(got, want)
    _normals_no_worse(got, want, cams[:1])


def test_float_wire_matches_jax(sessions, frames):
    js, ts, _ = sessions
    images, cams = frames
    f32 = normalize_images(images[:1].astype(np.float32) / 255.0)
    want = js.predict(f32, cams[:1])
    got = ts.predict(f32, cams[:1])
    _check(got, want)
    u8 = ts.predict(images[:1], cams[:1])
    assert np.abs(got["idepth"] - u8["idepth"]).max() < 1e-4  # the two wires agree


def test_chunk_pad_crop_matches_jax(sessions, frames):
    """B = 3 over buckets (1, 2): a top-bucket chunk of 2, then one frame."""
    js, ts, _ = sessions
    images, cams = frames
    want = js.predict(images, cams)
    got = ts.predict(images, cams)
    assert got["depth"].shape == (3, H, W)
    _check(got, want)
    _normals_no_worse(got, want, cams)


def test_padding_does_not_change_results(sessions, frames):
    _, ts, variables = sessions
    images, cams = frames
    padded = InferenceSession(_cfg(Config), flax_variables=variables, batch_buckets=(4,),
                              device="cpu")
    got = padded.predict(images, cams)  # 3 -> bucket 4, cropped back
    want = ts.predict(images, cams)
    for name in want:
        assert got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-5)


def test_output_subsets_and_f16_wire(sessions, frames):
    _, ts, variables = sessions
    images, cams = frames
    full = ts.predict(images[:1], cams[:1])
    sub = InferenceSession(_cfg(Config), flax_variables=variables, batch_buckets=(1, 2),
                           outputs=("normal", "idepth"), wire_dtype="float16", device="cpu")
    got = sub.predict(images[:1], cams[:1])
    assert set(got) == {"normal", "idepth"} and got["idepth"].dtype == np.float32
    for name in got:
        err = np.abs(got[name] - full[name])
        assert (err <= 2.0**-10 * np.abs(full[name]) + 1e-7).all(), name
    only_prob = InferenceSession(_cfg(Config), flax_variables=variables, outputs=("prob",),
                                 device="cpu")
    assert set(only_prob.predict(images[:1], cams[:1])) == {"prob"}
    with pytest.raises(ValueError, match="select nothing"):  # 2 views have no prob
        only_prob.predict(images[:1, :2], cams[:1, :2])


def test_f16_wire_saturates(sessions, frames):
    _, _, variables = sessions
    images, cams = frames
    s = InferenceSession(_cfg(Config), flax_variables=variables, outputs=("depth",),
                         wire_dtype="float16", device="cpu")
    s.model.refine_net.disp_refine[0].bias.data.fill_(-1e4)  # idepth -> 0, depth -> 1e8
    out = s.predict(images[:1], cams[:1])
    assert np.isfinite(out["depth"]).all() and out["depth"].max() == 65504.0


def test_two_view_path(sessions, frames):
    js, ts, _ = sessions
    images, cams = frames
    got = ts.predict(images[:1, :2], cams[:1, :2])
    assert set(got) == {"idepth", "depth", "normal"}
    _check(got, js.predict(images[:1, :2], cams[:1, :2]))


def test_constructor_contract(sessions):
    _, _, variables = sessions
    with pytest.raises(ValueError, match="at least one"):
        InferenceSession(_cfg(Config), outputs=(), device="cpu")
    with pytest.raises(ValueError, match="unknown outputs"):
        InferenceSession(_cfg(Config), outputs=("albedo",), device="cpu")
    with pytest.raises(ValueError, match="wire_dtype"):
        InferenceSession(_cfg(Config), wire_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="not both"):
        InferenceSession(_cfg(Config), state_dict={}, flax_variables=variables, device="cpu")


def test_warmup_runs_every_bucket(sessions, monkeypatch):
    _, ts, _ = sessions
    seen = []
    run = ts._run
    monkeypatch.setattr(ts, "_run", lambda images, cams: seen.append(images.shape) or run(images, cams))
    ts.warmup(3, H, W)
    assert seen == [(1, 3, H, W, 3), (2, 3, H, W, 3)]


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceSession(_cfg(Config))  # the default device is cuda


def test_seeded_init_and_state_dict_round_trip(frames):
    images, cams = frames
    a = InferenceSession(_cfg(Config), seed=3, device="cpu")
    b = InferenceSession(_cfg(Config), seed=3, device="cpu")
    c = InferenceSession(_cfg(Config), state_dict=a.model.state_dict(), device="cpu")
    for x, y in zip(a.model.state_dict().values(), b.model.state_dict().values()):
        assert torch.equal(x, y)
    w = a.model.depth_net.conv2[0].weight
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    assert abs(w.std().item() / np.sqrt(2.0 / fan_out) - 1.0) < 0.05  # He-normal fan-out
    out_a, out_c = a.predict(images[:1], cams[:1]), c.predict(images[:1], cams[:1])
    for name in out_a:
        np.testing.assert_array_equal(out_a[name], out_c[name])


def test_synthetic_scenes_match_jax():
    ours = SyntheticScenes(num_samples=2, height=H, width=W, view_num=3, seed=5)
    theirs = JScenes(num_samples=2, height=H, width=W, view_num=3, seed=5)
    a, b = collate([ours[i] for i in range(2)]), j_collate([theirs[i] for i in range(2)])
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
