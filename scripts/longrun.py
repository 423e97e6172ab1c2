"""LONGRUN: a long KITTI-layout run through the production driver.

Generates a 4,600-frame KITTI-layout synthetic sequence — KITTI-00
intrinsics and resolution (1241x376, fx 718.856, baseline 0.537 m),
outdoor depth statistics (ground plane at KITTI camera height, distant
walls), FOUR laps of a 60 m-radius circuit (multiple revisit events, like
00's loop structure), per-pixel sensor noise — writes it to disk as
`<out>/times.txt image_0/%06d.png image_1/%06d.png poses.txt`, then
drives the production path end-to-end: `scripts/run_kitti.py --chunk`
(native PNG decode -> prefetch upload -> chunked scan engine -> batched
loop closing), with and without loop closing, and reports
keyframe-trajectory ATE vs ground truth into `<out>/longrun.json`.

Everything runs in ONE process, which alone holds the device: rendering,
then each run_kitti pass in turn. PNGs are written with zlib (no OpenCV);
reading them back uses the native loader (needs g++ and zlib) or, failing
that, OpenCV.

The run intentionally crosses the loop database's initial capacity (the
longrun config caps it at 256 rows) so database growth is exercised at
full scale.

Usage:
  python scripts/longrun.py [--out DIR] [--frames 4608]
                            [--chunk 32] [--skip-generate] [--laps 4]
(DIR defaults to .cache/longrun_kitti in the checkout.)
"""

import argparse
import contextlib
import io
import json
import os
import struct
import sys
import time
import zlib

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

FX, FY = 718.856, 718.856
CX, CY = 607.1928, 185.2157
BASE = 0.537
W_IMG, H_IMG = 1241, 376


def write_png_gray(path: str, img) -> None:
    """8-bit grayscale PNG (filter 0 on every row)."""
    h, w = img.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def gen_dataset(out: str, n_frames: int, laps: int, chunk: int) -> None:
    import jax
    import numpy as np

    from ssvio_tpu.dataio import synthetic, synthetic_jax

    per_lap = n_frames // laps
    circ = synthetic.loop_trajectory(per_lap, radius=60.0)
    poses = np.concatenate([circ] * laps, axis=0)[:n_frames]
    # outdoor statistics: ground at KITTI camera height (1.65 m), walls
    # 75 m out (structure 15-135 m away; most useful parallax comes from
    # the road surface, as on KITTI), open "ceiling" far above
    world = synthetic.SyntheticWorld(seed=23, ground_y=1.65, wall_x=75.0,
                                     ceiling_y=-30.0)

    os.makedirs(os.path.join(out, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(out, "image_1"), exist_ok=True)
    wa = synthetic_jax.world_arrays(world)
    key = jax.random.PRNGKey(5)
    t0 = time.time()
    for c in range(0, n_frames, chunk):
        P = np.asarray(poses[c:c + chunk], np.float32)
        L, R = synthetic_jax.render_stereo_chunk(
            wa, P, FX, FY, CX, CY, BASE, W_IMG, H_IMG, u8=True,
            noise_std=2.0, key=key, frame0=c)
        L = np.asarray(L)
        R = np.asarray(R)
        for j in range(L.shape[0]):
            write_png_gray(os.path.join(out, "image_0", f"{c + j:06d}.png"),
                           L[j])
            write_png_gray(os.path.join(out, "image_1", f"{c + j:06d}.png"),
                           R[j])
        if c % (chunk * 16) == 0:
            print(f"[longrun] rendered {c}/{n_frames} "
                  f"({c / max(time.time() - t0, 1e-9):.1f} fps)", flush=True)
    with open(os.path.join(out, "times.txt"), "w") as f:
        for i in range(n_frames):
            f.write(f"{0.1 * i:.6e}\n")
    with open(os.path.join(out, "poses.txt"), "w") as f:
        for i in range(n_frames):
            f.write(" ".join(f"{v:.9e}" for v in poses[i].reshape(-1)) + "\n")
    print(f"[longrun] dataset at {out}: {n_frames} stereo pairs "
          f"({time.time() - t0:.0f}s)")


LONGRUN_CONFIG = {
    "Camera1.fx": FX, "Camera1.fy": FY, "Camera1.cx": CX, "Camera1.cy": CY,
    "Camera2.fx": FX, "Camera2.fy": FY, "Camera2.cx": CX, "Camera2.cy": CY,
    "Camera.width": W_IMG, "Camera.height": H_IMG,
    "Camera.Base.Line": BASE * FX, "Camera.fps": 10,
    "Map.ActiveMap.Size": 12,
    "numFeatures.initGood": 100, "numFeatures.trackingGood": 120,
    "numFeatures.trackingBad": 10,
    "ORBextractor.nInitFeatures": 512, "ORBextractor.nNewFeatures": 512,
    "Min.Init.Landmark.Num": 150,
    "Backend.Open": 1, "Loop.Closing.Open": 1,
    "TPU.Max.Features": 512, "TPU.Max.Landmarks": 8192,
    "TPU.Max.Keyframes.DB": 256,
}


def run_pass(out: str, chunk: int, loop_on: bool, tag: str):
    """One run_kitti pass in this process; returns (traj, stdout, wall)."""
    import run_kitti
    from ssvio_tpu.config import Settings

    traj = os.path.join(out, f"traj_{tag}.tum")
    argv = ["--kitti_dataset_path", out,
            "--gt_poses", os.path.join(out, "poses.txt"),
            "--chunk", str(chunk), "--save_traj", traj]
    if not loop_on:
        argv.append("--no_loop")
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = run_kitti.main(argv, settings=Settings.from_dict(LONGRUN_CONFIG))
    wall = time.time() - t0
    stdout = buf.getvalue()
    sys.stdout.write(stdout[-3000:])
    if rc != 0:
        raise RuntimeError(f"run_kitti ({tag}) failed rc={rc}")
    return traj, stdout, wall


def evaluate(out: str, traj: str):
    import numpy as np

    from ssvio_tpu.dataio import kitti, tum
    from ssvio_tpu.eval import ate

    gt = kitti.load_kitti_gt_poses(os.path.join(out, "poses.txt"))
    ts, est = tum.load_tum(traj)
    idx = np.clip(np.round(np.asarray(ts) / 0.1).astype(int), 0,
                  len(gt) - 1)
    gt_sel = np.asarray(gt)[idx]
    stats = ate.ape_translation(est[:, :, 3], gt_sel[:, :, 3])
    # end-of-run drift with the gauge fixed on the first quarter
    q = max(4, len(idx) // 4)
    _, Rm, t = ate.umeyama_alignment(est[:q, :, 3], gt_sel[:q, :, 3])
    est_al = est[:, :, 3] @ Rm.T + t
    end_drift = float(np.linalg.norm(est_al[-1] - gt_sel[-1][:, 3]))
    return {"ate_rmse_m": round(stats["rmse"], 3),
            "ate_max_m": round(stats["max"], 3),
            "end_drift_m": round(end_drift, 3),
            "n_keyframes": int(len(ts))}


def parse_counters(stdout: str):
    import re
    m = re.search(r"(\d+) frames in ([0-9.]+)s \(([0-9.]+) fps\), "
                  r"(\d+) keyframes, (\d+) loop closures", stdout)
    if not m:
        return {}
    return {"frames": int(m.group(1)), "fps": float(m.group(3)),
            "n_keyframes": int(m.group(4)), "n_loops": int(m.group(5))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".cache", "longrun_kitti"))
    ap.add_argument("--frames", type=int, default=4608)
    ap.add_argument("--laps", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--skip-generate", action="store_true")
    ap.add_argument("--json-out", default=None,
                    help="report path (default <out>/longrun.json)")
    args = ap.parse_args()
    json_out = args.json_out or os.path.join(args.out, "longrun.json")

    if not args.skip_generate:
        gen_dataset(args.out, args.frames, args.laps, args.chunk)

    report = {"frames": args.frames, "laps": args.laps,
              "dataset": {"resolution": f"{W_IMG}x{H_IMG}",
                          "intrinsics": "KITTI-00", "baseline_m": BASE,
                          "trajectory": f"{args.laps} laps x 60 m radius "
                                        f"(~{377 * args.laps} m path)",
                          "noise_std_gray": 2.0},
              "db_initial_cap": 256}
    for tag, loop_on in (("loop_on", True), ("loop_off", False)):
        traj, stdout, wall = run_pass(args.out, args.chunk, loop_on, tag)
        r = evaluate(args.out, traj)
        r.update(parse_counters(stdout))
        r["wall_s"] = round(wall, 1)
        grew = [ln for ln in stdout.splitlines() if "database grown" in ln]
        if grew:
            r["db_growth"] = grew
        report[tag] = r
        print(f"[longrun] {tag}: {r}")

    with open(json_out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[longrun] wrote {json_out}")


if __name__ == "__main__":
    main()
