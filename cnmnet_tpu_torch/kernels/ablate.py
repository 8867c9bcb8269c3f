"""Kernel ablations on one NVIDIA card: what each part of a kernel costs.

    python -m cnmnet_tpu_torch.kernels.ablate

Builds variants of the CUDA sources in ``csrc/``, each a text substitution
of the shipped source compiled by ``nvcc`` into a temporary directory
under the build directory, and
times each at the serving shapes (CUDA events, median of 20 runs of 10
launches), and records whether its output equals the shipped kernel's bit
for bit ("exact"). A variant that drops part of the work measures what
that part costs.

* cost volume, bf16 out, 2 and 16 pairs of 192x256 frames, 64 planes:
  ``shipped``; ``no_gather`` (the four taps come from registers: the
  arithmetic alone); ``shared_reciprocal`` (X / d and Y / d through one
  rounded reciprocal and a correction step each); ``pack_only`` (the pack
  launch alone);
* depth->normal, k = 9, B = 1 and 8 at 192x256: ``shipped`` (64 x 8
  tiles of 256 threads); ``tall_tiles`` (64 x 16 tiles of 512 threads).

Prints the card's ``nvidia-smi`` name and power limit and one JSON line of
microseconds. Needs a card and the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from cnmnet_tpu_torch.data.pipeline import collate, normalize_images
from cnmnet_tpu_torch.data.synthetic import SyntheticScenes
from cnmnet_tpu_torch.geometry.camera import camera_from_array, invert_intrinsics
from cnmnet_tpu_torch.kernels import build
from cnmnet_tpu_torch.kernels import cost_volume as kcv
from cnmnet_tpu_torch.kernels import normals as kn
from cnmnet_tpu_torch.ops import cost_volume as pcv

H, W, P, K = 192, 256, 64, 9

COST_VOLUME = {
    "shipped": [],
    "no_gather": [(
        "  const float4 a = __ldg(q);\n  const float4 b = __ldg(q + 1);\n"
        "  const float4 c = __ldg(q + Wp);\n  const float4 d = __ldg(q + Wp + 1);",
        "  const float f = __uint_as_float(t.idx);\n"
        "  const float4 a = make_float4(f, t.fx, t.fy, 0.f), b = make_float4(t.fy, f, t.fx, 0.f);\n"
        "  const float4 c = make_float4(t.fx, t.fy, f, 0.f), d = make_float4(f, f, t.fx, 0.f);",
    )],
    "shared_reciprocal": [(
        "  const float x = fminf(fmaxf(__fdiv_rn(X, denom), -bound), bound);\n"
        "  const float y = fminf(fmaxf(__fdiv_rn(Y, denom), -bound), bound);",
        "  const float rr = __frcp_rn(denom);\n"
        "  const float qx = __fmul_rn(X, rr), qy = __fmul_rn(Y, rr);\n"
        "  const float x = fminf(fmaxf(__fmaf_rn(__fmaf_rn(-qx, denom, X), rr, qx), -bound), bound);\n"
        "  const float y = fminf(fmaxf(__fmaf_rn(__fmaf_rn(-qy, denom, Y), rr, qy), -bound), bound);",
    )],
    "pack_only": [(
        "  const int items = B * H * ((W + kChunk - 1) / kChunk)",
        "  return 0;\n  const int items = B * H * ((W + kChunk - 1) / kChunk)",
    )],
}
DEPTH_TO_NORMAL = {
    "shipped": [],
    "tall_tiles": [
        ("constexpr int kTileH = 8;", "constexpr int kTileH = 16;"),
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 512;"),
        ("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 2;"),
    ],
}


def device_ms(fn, runs=20, reps=10):
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


def variant_source(source: str, name: str, subs) -> str:
    """``csrc/<source>.cu`` with each ``(old, new)`` of ``subs`` applied;
    every ``old`` must occur exactly once."""
    body = (build.CSRC / f"{source}.cu").read_text()
    for old, new in subs:
        if body.count(old) != 1:
            raise RuntimeError(f"{source}.cu must hold the text variant {name} replaces once")
        body = body.replace(old, new)
    return body


def build_variants(source: str, variants: dict, tmp: Path) -> dict:
    """``{name: ctypes.CDLL}``: every variant compiled at once, one nvcc each."""
    jobs = {}
    for name, subs in variants.items():
        body = variant_source(source, name, subs)
        cu, so = tmp / f"{source}_{name}.cu", tmp / f"{source}_{name}.so"
        cu.write_text(body)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def frames(n: int, seed: int, views: int):
    ds = SyntheticScenes(num_samples=n, height=H, width=W, view_num=views, seed=seed)
    return collate([ds[i] for i in range(n)])


def _cuda(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def cost_volume_inputs(n_frames: int, seed: int):
    """The serving path's folded pairs of ``n_frames`` 3-view frames."""
    batch = frames(n_frames, seed, 3)
    images = normalize_images(batch["images"])
    cams = batch["cams"].astype(np.float32)
    ref, src = np.repeat(images[:, 0], 2, 0), images[:, 1:].reshape(-1, H, W, 3)
    rc, sc = np.repeat(cams[:, 0], 2, 0), cams[:, 1:].reshape(-1, 2, 4, 4)
    coefs = kcv.pack_coefs(camera_from_array(_cuda(rc)), camera_from_array(_cuda(sc)))
    return _cuda(ref), _cuda(src), coefs


def time_cost_volume(libs: dict) -> dict:
    idepths = pcv.idepth_hypotheses(3.0, P, torch.device("cuda"))
    stream = torch.cuda.current_stream().cuda_stream
    result = {name: {"exact": True} for name in libs}
    for n_frames, seed in ((1, 5), (8, 6)):
        ref, src, coefs = cost_volume_inputs(n_frames, seed)
        B = ref.shape[0]
        scratch = torch.empty(kcv.bordered_shape(B, H, W), device="cuda")
        outs = {}
        for name, lib in libs.items():
            fn = lib.cnm_cost_volume
            fn.argtypes, fn.restype = kcv._ARGTYPES, ctypes.c_int
            out = torch.zeros((B, P, H, W), dtype=torch.bfloat16, device="cuda")
            args = (ref.data_ptr(), src.data_ptr(), scratch.data_ptr(), coefs.data_ptr(),
                    idepths.data_ptr(), out.data_ptr(), B, H, W, P, H, 0, 1, stream)
            build.check(fn(*args), f"cost volume variant {name}")
            result[name][f"{B}_pairs_us"] = device_ms(lambda: fn(*args)) * 1e3
            outs[name] = out
        for name, out in outs.items():
            result[name]["exact"] &= torch.equal(out, outs["shipped"])
    return result


def time_depth_to_normal(libs: dict) -> dict:
    stream = torch.cuda.current_stream().cuda_stream
    result = {name: {"exact": True} for name in libs}
    for B in (1, 8):
        batch = frames(B, 40 + B, 1)
        depth = _cuda(batch["depths"][:, 0])
        kinv = invert_intrinsics(_cuda(batch["cams"][:, 0, 1, :3, :3])).contiguous()
        outs = {}
        for name, lib in libs.items():
            fn = lib.cnm_depth_to_normal
            fn.argtypes, fn.restype = kn._ARGTYPES, ctypes.c_int
            out = torch.empty((B, H, W, 3), device="cuda")
            args = (depth.data_ptr(), kinv.data_ptr(), out.data_ptr(), B, H, W, K, 0,
                    0.0, 10.0, 1e-5, 1e-5, stream)
            build.check(fn(*args), f"depth->normal variant {name}")
            result[name][f"B{B}_us"] = device_ms(lambda: fn(*args)) * 1e3
            outs[name] = out
        for name, out in outs.items():
            result[name]["exact"] &= torch.equal(out, outs["shipped"])
    return result


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablate: torch.cuda.is_available() is False; this needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        cv = build_variants("cost_volume", COST_VOLUME, Path(tmp))
        dn = build_variants("depth_to_normal", DEPTH_TO_NORMAL, Path(tmp))
        result = {"cost_volume": time_cost_volume(cv), "depth_to_normal": time_depth_to_normal(dn)}
    print(smi.splitlines()[0])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
