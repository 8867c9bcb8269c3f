"""Smoke run of cnmnet_tpu_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``cnmnet_tpu_torch/kernels/csrc`` (one nvcc per
source, in parallel), then:

1. prints the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
   name and power limit) and turns TF32 off for the f32 checks;
2. holds each kernel against its plain PyTorch version on the card: the cost
   volume at the serving shape (2 pairs, 192x256, 64 planes) in f32 and
   bf16, at (30, 100, 6), (40, 130, 9) and 480x640x64; depth->normal at
   B in {1, 8} x k in {5, 9} at 192x256, at 480x640 and at an odd size,
   judged against the plain version in f64;
3. serves the 3-view refined forward at full width (CNMModel, 64 planes,
   192x256, bf16, seeded weights whose BatchNorm statistics are taken from
   synthetic frames) through ``InferenceSession.predict`` on
   requests of batch 1 (uint8), 3 (f32, padded to bucket 4) and 8, and on an
   f16 wire, with both kernels' launch counters set to 0 just before and
   read just after; checks shapes, ranges, unit normals, the bf16 session
   against an f32 one and the f32 kernel session against an f32 session of
   plain versions;
4. times each kernel and its plain version (CUDA events, median of 20 runs
   after warm-up) and ``predict`` at buckets 1 and 8;
5. traces one ``predict`` at buckets 1 and 8 (torch.profiler) and prints the
   device's busy time, its idle share and the kernels that take the time.

Prints the build seconds, the kernel table as one JSON line, the card's
name and power limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Any failed check raises, and the script exits non-zero without that line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

H, W, P, K = 192, 256, 64, 9
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# f32 operations per cost-volume output (pair, plane, pixel): X, Y, Z 6;
# z + eps 1; two divisions 2; floors 2; fractions 2; 1 - f 2; four weights
# 4; 12 tap products and 12 accumulations 24; three differences, abs and
# two adds 8; the clip 4. The per-pixel terms are amortised over the planes.
CV_FLOPS = 55


def normals_flops(k: int) -> int:
    """f32 operations per pixel of depth->normal: backprojection 18,
    monomials 6, two separable k-tap passes over 9 sums 18 (k - 1), the
    adjugate solve and normalisation 62."""
    return 18 + 6 + 18 * (k - 1) + 62


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def device_ms(torch, fn, runs=20, reps=10):
    """Median over ``runs`` of the device time per call of ``fn``, from CUDA
    events around ``reps`` back-to-back calls queued behind a device-side
    sleep (so the host's enqueue time does not show as gaps)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms of device time at ~2 GHz
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def synthetic_batch(n, height, width, views, seed):
    from cnmnet_tpu_torch.data.pipeline import collate
    from cnmnet_tpu_torch.data.synthetic import SyntheticScenes

    ds = SyntheticScenes(num_samples=n, height=height, width=width, view_num=views, seed=seed)
    return collate([ds[i] for i in range(n)])


# -- phase 2: kernels against their plain versions ---------------------------


def cv_inputs(torch, B, h, w, seed, batch=None):
    """Folded (ref, src) pairs and cameras on the card: from a synthetic
    3-view batch when given, else white noise under random cameras."""
    from cnmnet_tpu_torch.data.pipeline import normalize_images
    from cnmnet_tpu_torch.geometry.camera import camera_from_array

    if batch is not None:
        images = normalize_images(batch["images"])
        cams = batch["cams"].astype(np.float32)
        S = images.shape[1] - 1
        ref = np.repeat(images[:, 0], S, 0)
        src = images[:, 1:].reshape((-1,) + images.shape[2:])
        rc = np.repeat(cams[:, 0], S, 0)
        sc = cams[:, 1:].reshape(-1, 2, 4, 4)
    else:
        rng = np.random.default_rng(seed)
        ref = rng.standard_normal((B, h, w, 3)).astype(np.float32)
        src = rng.standard_normal((B, h, w, 3)).astype(np.float32)
        rc = np.zeros((B, 2, 4, 4), np.float32)
        rc[:, 0] = np.eye(4)
        rc[:, 1, :3, :3] = [[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]]
        sc = rc.copy()
        for b in range(B):
            a = 0.03 * rng.standard_normal()
            sc[b, 0, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
            sc[b, 0, :3, 3] = 0.08 * rng.standard_normal(3)
    dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()  # noqa: E731
    return dev(ref), dev(src), camera_from_array(dev(rc)), camera_from_array(dev(sc))


def check_cost_volume(torch, h, w, planes, B, seed, batch=None):
    """Kernel vs plain on the card, f32 and bf16; returns the max f32 error
    and the max bf16 error against the plain version rounded to bf16 (the
    serving path's volume)."""
    from cnmnet_tpu_torch.kernels import cost_volume as kcv
    from cnmnet_tpu_torch.ops import cost_volume as pcv

    ref, src, rc, sc = cv_inputs(torch, B, h, w, seed, batch)
    plain = pcv.cost_volume_from_cameras(ref, src, rc, sc, 3.0, planes)
    f32 = kcv.cost_volume(ref, src, rc, sc, 3.0, planes, torch.float32)
    bf16 = kcv.cost_volume(ref, src, rc, sc, 3.0, planes, torch.bfloat16)
    torch.cuda.synchronize()
    assert f32.shape == plain.shape == (B, h, w, planes), (f32.shape, plain.shape)
    err = (f32 - plain).abs().max().item()
    # bf16 rounding is within half an ulp, 2^-8 of the value
    err_bf = ((bf16.float() - plain).abs() - 2.0**-8 * plain.abs()).max().item()
    err_bf_abs = (bf16.float() - plain.to(torch.bfloat16).float()).abs().max().item()
    print(f"check cost_volume B={B} {h}x{w}x{planes}: max|kernel-plain| f32 {err:.3e} "
          f"(tol 1e-4); bf16 max(|kernel-plain| - 2^-8 |plain|) {err_bf:.3e} (tol 1e-4), "
          f"max|kernel-bf16(plain)| {err_bf_abs:.3e}")
    assert err <= 1e-4, err
    assert err_bf <= 1e-4, err_bf
    return err, err_bf_abs


def oracle_f64(torch, depth, kinv, k):
    """The plain version in f64 on the card: (unit normals, determinants)."""
    from cnmnet_tpu_torch.geometry.warp import pixel2cam
    from cnmnet_tpu_torch.ops import normals as pn

    d, ki = depth.double(), kinv.double()
    p = pixel2cam(d, ki) * ((d > 0) & (d < 10)).double()[..., None]
    x, y, z = p.unbind(-1)
    mom = pn.box_filter(torch.stack([x * x, x * y, x * z, y * y, y * z, z * z, x, y, z], -1), k)
    a, b, c, dd, e, f = mom[..., :6].unbind(-1)
    det = a * (dd * f - e * e) - b * (b * f - c * e) + c * (b * e - c * dd)
    n, _ = pn.depth_to_normal(d, ki, k)
    return n, det


def angles(torch, n, truth, det):
    """Angles (deg) to the f64 truth over well-posed pixels (truth norm >
    0.5, |det| > 1e-3: away from the singular threshold, where two f32
    implementations tie-break on rounding)."""
    n = n.double()
    keep = (truth.norm(dim=-1) > 0.5) & (det.abs() > 1e-3)
    cos = (n * truth).sum(-1) / (n.norm(dim=-1) * truth.norm(dim=-1)).clamp_min(1e-12)
    return torch.rad2deg(torch.arccos(cos.clamp(-1, 1)))[keep], keep


def check_normals(torch, depth, kinv, k):
    """Kernel no worse than the f32 plain version against the f64 plain
    version (mean < 2x + 0.05 deg, max < max(2x, 1 deg)), and equal to the
    f32 plain version to 1e-6 at every pixel (both round at the same steps
    in the same order); returns the max |kernel - plain f32|."""
    from cnmnet_tpu_torch.kernels import normals as kn
    from cnmnet_tpu_torch.ops import normals as pn

    got, _ = kn.depth_to_normal(depth, kinv, k)
    want, _ = pn.depth_to_normal(depth, kinv, k)
    truth, det = oracle_f64(torch, depth, kinv, k)
    torch.cuda.synchronize()
    a, keep = angles(torch, got, truth, det)
    r, _ = angles(torch, want, truth, det)
    diff = (got - want).abs().amax(-1)
    err = diff.max().item()
    B, h, w = depth.shape
    print(f"check depth_to_normal B={B} {h}x{w} k={k}: angle to f64 kernel mean "
          f"{a.mean().item():.4f} max {a.max().item():.4f} deg, plain f32 mean "
          f"{r.mean().item():.4f} max {r.max().item():.4f} deg over {int(keep.sum())} "
          f"well-posed pixels; max|kernel-plain| {err:.3e}, pixels off by > 1e-6: "
          f"{int((diff > 1e-6).sum())} of {diff.numel()}")
    assert keep.sum() > 0.5 * keep.numel()
    assert a.mean() < r.mean() * 2 + 0.05 and a.max() < max(r.max().item() * 2, 1.0)
    assert err <= 1e-6, err
    return err


def normals_inputs(torch, B, h, w, seed):
    """Depth maps of synthetic rooms (some pixels invalid) and their K^-1."""
    from cnmnet_tpu_torch.geometry.camera import invert_intrinsics

    batch = synthetic_batch(B, h, w, 1, seed)
    depth = torch.from_numpy(batch["depths"][:, 0]).cuda()
    kinv = invert_intrinsics(torch.from_numpy(batch["cams"][:, 0, 1, :3, :3]).cuda())
    return depth.contiguous(), kinv.contiguous()


# -- phase 3: the serving slice ----------------------------------------------


def calibrate_batch_norm(torch, model, images, cams):
    """Set every BatchNorm's running statistics to those of one batch
    (a train-mode forward without gradients, cumulative average). Seeded
    He-normal weights under the fresh statistics (mean 0, var 1) leave the
    activations unnormalised, and the heads' sigmoids saturate: idepth is 0
    or 3 at most pixels. Statistics taken from frames, as a trained net has
    them, keep the outputs inside their ranges."""
    from torch import nn

    from cnmnet_tpu_torch.ops.images import prepare_images

    norms = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for bn in norms:
        bn.reset_running_stats()
        bn.momentum = None
    model.train()
    with torch.no_grad():
        model(prepare_images(images), cams)
    model.eval()
    for bn in norms:
        bn.momentum = 0.1


def serve_phase(torch, counters):
    from cnmnet_tpu_torch.config import Config
    from cnmnet_tpu_torch.data.pipeline import normalize_images, quantize_images_u8
    from cnmnet_tpu_torch.serve import InferenceSession

    batch = synthetic_batch(8, H, W, 3, seed=11)
    u8 = quantize_images_u8(batch["images"])
    f32 = normalize_images(u8.astype(np.float32) / 255.0)
    cams = batch["cams"].astype(np.float32)
    cfg = Config()  # 64 planes, k = 9, 192x256

    # seeded weights, BatchNorm statistics from other frames of the same kind
    full32 = InferenceSession(cfg, seed=0, compute_dtype="float32", device="cuda")
    calib = synthetic_batch(4, H, W, 3, seed=12)
    calibrate_batch_norm(
        torch, full32.model, torch.from_numpy(quantize_images_u8(calib["images"])).cuda(),
        torch.from_numpy(calib["cams"].astype(np.float32)).cuda(),
    )
    weights = full32.model.state_dict()
    session = InferenceSession(cfg, state_dict=weights, device="cuda")
    wire16 = InferenceSession(cfg, state_dict=weights, wire_dtype="float16", device="cuda")
    assert session.compute_dtype == torch.bfloat16
    session.predict(u8[:1], cams[:1])  # loads the kernels before the counted run

    for c in counters.values():
        c.launches = 0
    outs = {
        "b1_u8": session.predict(u8[:1], cams[:1]),
        "b3_f32": session.predict(f32[:3], cams[:3]),
        "b8_u8": session.predict(u8, cams),
        "b1_f16": wire16.predict(u8[:1], cams[:1]),
    }
    launches = {name: c.launches for name, c in counters.items()}
    print(f"launches during predict (4 requests): {launches}")
    for name, n in launches.items():
        assert n >= 1, f"kernel {name} was not launched on the serving path"

    for key, out in outs.items():
        B = int(key[1])
        assert set(out) == {"idepth", "depth", "prob", "normal"}, (key, set(out))
        assert out["idepth"].shape == out["depth"].shape == out["prob"].shape == (B, H, W)
        assert out["normal"].shape == (B, H, W, 3)
        for name, a in out.items():
            assert np.isfinite(a).all(), (key, name)
        assert 0.0 <= out["prob"].min() and out["prob"].max() <= 1.0, key
        # idepth = 3 sigmoid(x) lies in (0, 3], but f32's sigmoid gives 0 for
        # x < -88, which random heads can reach
        assert 0.0 <= out["idepth"].min() and out["idepth"].max() <= 3.0, key
        valid = (out["depth"] > 0) & (out["depth"] < 10)
        norm = np.linalg.norm(out["normal"], axis=-1)[valid]
        assert valid.any() and np.abs(norm - 1.0).max() < 1e-3, (key, np.abs(norm - 1).max())
    a, b = outs["b1_f16"], outs["b1_u8"]
    for name in ("idepth", "prob", "normal"):
        assert (np.abs(a[name] - b[name]) <= 2.0**-10 * np.abs(b[name]) + 1e-6).all(), name
    assert np.allclose(a["depth"], np.minimum(b["depth"], 65504.0), rtol=2.0**-10)

    # bf16 against f32 (TF32 off), and the f32 kernels against the f32 plain versions
    cfg_plain = Config()
    cfg_plain.model.cv_backend = "torch"
    plain32 = InferenceSession(cfg_plain, state_dict=weights, compute_dtype="float32",
                               device="cuda")
    o32 = full32.predict(u8, cams)
    op = plain32.predict(u8, cams)
    o16 = outs["b8_u8"]
    kernel_vs_plain = {k: np.abs(o32[k] - op[k]).max() for k in ("idepth", "prob", "normal")}
    kvp_rel_l2 = np.linalg.norm(o32["idepth"] - op["idepth"]) / np.linalg.norm(op["idepth"])
    rel_l2 = np.linalg.norm(o16["idepth"] - o32["idepth"]) / np.linalg.norm(o32["idepth"])
    mean_abs = np.abs(o16["idepth"] - o32["idepth"]).mean()
    prob_mean_abs = np.abs(o16["prob"] - o32["prob"]).mean()
    print(f"f32 session, batch 8, kernels vs plain versions: max|d| "
          f"{ {k: float(f'{v:.3e}') for k, v in kernel_vs_plain.items()} } (idepth tol 1e-2), "
          f"idepth relative L2 {kvp_rel_l2:.3e} (tol 1e-4)")
    print(f"bf16 vs f32 session, batch 8: idepth relative L2 {rel_l2:.4e} (tol 0.25), "
          f"mean|d| {mean_abs:.4e} (tol 0.25); prob mean|d| {prob_mean_abs:.4e}; "
          f"f32 idepth range [{o32['idepth'].min():.3e}, {o32['idepth'].max():.3e}]")
    # The kernels agree with the plain versions to an ulp or exactly. Random
    # weights amplify an ulp of the volume through the conv stack, at the most
    # sensitive pixels to some 1e-3 (one earlier run: 2.3e-3), far less on the
    # whole map.
    assert kernel_vs_plain["idepth"] <= 1e-2 and kvp_rel_l2 <= 1e-4
    # bf16 rounds every activation to 8 significant bits; random weights
    # amplify that through ~30 layers into the heads' pre-sigmoids (std ~6),
    # so the maps differ by some percent of their range (0.14 in both
    # measures on the CPU at 64x96): tolerance 0.25, a twelfth of the range.
    assert rel_l2 <= 0.25 and mean_abs <= 0.25
    del full32, plain32
    return session, u8, cams, launches


# kernel name fragment -> class, first match wins
KERNEL_CLASSES = (
    ("cost_volume_kernel", "cost volume"),
    ("depth_to_normal_kernel", "depth->normal"),
    ("nchwToNhwc", "layout transposes"),
    ("nhwcToNchw", "layout transposes"),
    ("upsample", "upsampling"),
    ("batch_norm", "batch norm"),
    ("xmma", "convolutions"),
    ("cutlass", "convolutions"),
    ("conv", "convolutions"),
    ("gemm", "convolutions"),
)


def profile_predict(torch, session, images, cams):
    """One traced ``predict`` (torch.profiler): its host wall ms under the
    profiler, the device's busy ms (the sum of kernel times; one stream, so
    kernels do not overlap), ms by kernel class, and ``(name, ms, count)``
    per kernel."""
    from torch.profiler import ProfilerActivity, profile

    session.predict(images, cams)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        session.predict(images, cams)
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    classes = {}
    for key, ms, _ in rows:
        cls = next((c for frag, c in KERNEL_CLASSES if frag in key), "other")
        classes[cls] = classes.get(cls, 0.0) + ms
    return wall_ms, sum(r[1] for r in rows), classes, rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2

    from cnmnet_tpu_torch.kernels import build
    from cnmnet_tpu_torch.kernels import cost_volume as kcv
    from cnmnet_tpu_torch.kernels import normals as kn
    from cnmnet_tpu_torch.ops import cost_volume as pcv
    from cnmnet_tpu_torch.ops import normals as pn

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind} (count {torch.cuda.device_count()}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    print(f"build: {build_s:.2f} s for {len(logs)} sources")

    # 2. kernels against their plain versions
    main_batch = synthetic_batch(1, H, W, 3, seed=5)
    _, cv_err = check_cost_volume(torch, H, W, P, 2, 0, main_batch)
    check_cost_volume(torch, 30, 100, 6, 2, 1)
    check_cost_volume(torch, 40, 130, 9, 2, 2)
    check_cost_volume(torch, 480, 640, 64, 2, 3)
    nrm_err = None
    for B in (1, 8):
        depth, kinv = normals_inputs(torch, B, H, W, seed=20 + B)
        for k in (5, 9):
            e = check_normals(torch, depth, kinv, k)
            if B == 1 and k == K:
                nrm_err = e
    check_normals(torch, *normals_inputs(torch, 1, 480, 640, seed=30), K)
    check_normals(torch, *normals_inputs(torch, 2, 157, 203, seed=31), K)

    # 3. the serving slice, with the launch counters
    counters = {"cost_volume": kcv.cost_volume_kernel, "depth_to_normal": kn.depth_to_normal_kernel}
    session, u8, cams, launches = serve_phase(torch, counters)

    # 4. times at the serving shapes (batch 1: 2 pairs, one depth map)
    ref, src, rc, sc = cv_inputs(torch, 2, H, W, 0, main_batch)
    coefs = kcv.pack_coefs(rc, sc)
    idepths = pcv.idepth_hypotheses(3.0, P, ref.device)
    cv_ms = device_ms(torch, lambda: kcv.cost_volume_kernel(ref, src, coefs, idepths, torch.bfloat16))
    cv_plain_ms = device_ms(
        torch, lambda: pcv.cost_volume_from_cameras(ref, src, rc, sc, 3.0, P).to(torch.bfloat16))
    cv_bytes = ref.numel() * 4 * 2 + coefs.numel() * 4 + idepths.numel() * 4 + 2 * P * H * W * 2
    cv_bound, cv_by = bound(cv_bytes, 2 * P * H * W * CV_FLOPS)
    cv32_ms = device_ms(torch, lambda: kcv.cost_volume_kernel(ref, src, coefs, idepths))
    cv32_bound, cv32_by = bound(cv_bytes + 2 * P * H * W * 2, 2 * P * H * W * CV_FLOPS)

    rows = {}
    for B in (1, 8):
        depth, kinv = normals_inputs(torch, B, H, W, seed=40 + B)
        ms = device_ms(torch, lambda: kn.depth_to_normal_kernel(depth, kinv, K))
        plain_ms = device_ms(torch, lambda: pn.depth_to_normal(depth, kinv, K))
        nb = depth.numel() * 4 + kinv.numel() * 4 + depth.numel() * 12
        rows[B] = (ms, plain_ms) + bound(nb, depth.numel() * normals_flops(K))
    print(f"cost_volume f32 writeback (2 pairs): kernel {cv32_ms:.4f} ms, bound "
          f"{cv32_bound * 1e3:.2f} us ({cv32_by})")
    print(f"depth_to_normal B=8 k=9: kernel {rows[8][0]:.4f} ms, plain {rows[8][1]:.4f} ms, "
          f"bound {rows[8][2] * 1e3:.2f} us ({rows[8][3]})")

    rates = {}
    for B in (1, 8):
        imgs, cm = u8[:B], cams[:B]
        for _ in range(3):
            session.predict(imgs, cm)
        ts = []
        for _ in range(20):
            t = time.perf_counter()
            session.predict(imgs, cm)
            ts.append(time.perf_counter() - t)
        t = statistics.median(ts)
        rates[B] = (t * 1e3 / B, B / t)
        print(f"predict bucket {B} (uint8, bf16, all outputs): {t * 1e3:.3f} ms/request, "
              f"{t * 1e3 / B:.3f} ms/frame, {B / t:.2f} frames/s")

    # 5. where the time goes inside predict
    for B in (1, 8):
        wall, busy, classes, prof_rows = profile_predict(torch, session, u8[:B], cams[:B])
        if busy == 0:
            print(f"profile bucket {B}: the profiler recorded no device time (not measured)")
            continue
        shares = ", ".join(f"{c} {ms:.4f} ms" for c, ms in sorted(classes.items(), key=lambda x: -x[1]))
        print(f"profile bucket {B}: wall {wall:.3f} ms under the profiler, device busy "
              f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}; by class: {shares}")
        for key, ms, count in prof_rows[:8]:
            print(f"  {ms:9.4f} ms {count:4d}x {key[:110]}")

    kernels = [
        {"name": "cost_volume", "route": "cuda",
         "source": "cnmnet_tpu_torch/kernels/csrc/cost_volume.cu",
         "replaces": "cnmnet_tpu/kernels/cost_volume_pallas.py:417",
         "launches": launches["cost_volume"], "max_abs_err": cv_err, "ms": cv_ms,
         "plain_ms": cv_plain_ms, "bound_ms": cv_bound, "bound_by": cv_by, "library_ms": None},
        {"name": "depth_to_normal", "route": "cuda",
         "source": "cnmnet_tpu_torch/kernels/csrc/depth_to_normal.cu",
         "replaces": "cnmnet_tpu/kernels/normals_pallas.py:168",
         "launches": launches["depth_to_normal"], "max_abs_err": nrm_err, "ms": rows[1][0],
         "plain_ms": rows[1][1], "bound_ms": rows[1][2], "bound_by": rows[1][3],
         "library_ms": None},
    ]
    print(f"build_s {build_s:.2f}; predict ms/frame b1 {rates[1][0]:.3f} b8 {rates[8][0]:.3f}; "
          f"frames/s b1 {rates[1][1]:.2f} b8 {rates[8][1]:.2f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
