"""CLI entry: headless project workflow commands.

Port of caliscope_tpu/__main__.py (reference src/caliscope/__main__.py:46).
Every command takes --device (default cuda; --device cpu runs on the CPU),
on which the trackers and solvers run. `gui` is not ported (ROADMAP.md
item 26) and raises.

Usage:
    python -m caliscope_tpu_torch init <workspace>
    python -m caliscope_tpu_torch status <workspace>
    python -m caliscope_tpu_torch calibrate-intrinsics <workspace> [--cam N] [--frame-step 5]
    python -m caliscope_tpu_torch extract <workspace> [--frame-step 1]
    python -m caliscope_tpu_torch calibrate-extrinsics <workspace>
    python -m caliscope_tpu_torch reconstruct <workspace> <recording>
    python -m caliscope_tpu_torch export-board <workspace> <out.png>
"""

from __future__ import annotations

import argparse
import faulthandler
import sys
import tempfile
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="caliscope_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("init", help="initialize a new workspace skeleton")
    p.add_argument("workspace", type=Path)

    p = sub.add_parser("status", help="show workflow status")
    p.add_argument("workspace", type=Path)

    p = sub.add_parser("calibrate-intrinsics", help="run intrinsic calibration")
    p.add_argument("workspace", type=Path)
    p.add_argument("--cam", type=int, default=None, help="single camera (default: all)")
    p.add_argument("--frame-step", type=int, default=5)

    p = sub.add_parser("extract", help="synchronized 2D extraction for extrinsics")
    p.add_argument("workspace", type=Path)
    p.add_argument("--frame-step", type=int, default=1)

    p = sub.add_parser("calibrate-extrinsics", help="run the extrinsic pipeline")
    p.add_argument("workspace", type=Path)
    p.add_argument("--no-refine-intrinsics", action="store_true")
    p.add_argument("--filter-percentile", type=float, default=2.5)

    p = sub.add_parser("reconstruct", help="triangulate + export a recording")
    p.add_argument("workspace", type=Path)
    p.add_argument("recording", type=str)
    p.add_argument("--frame-step", type=int, default=1)

    p = sub.add_parser("gui", help="launch the GUI (not ported yet)")
    p.add_argument("workspace", type=Path, nargs="?", default=None)

    p = sub.add_parser("export-board", help="write the workspace's calibration board as a printable PNG")
    p.add_argument("workspace", type=Path)
    p.add_argument("out", type=Path)
    p.add_argument("--mirror", action="store_true", help="mirrored face (two-sided boards)")
    p.add_argument("--px-per-square", type=int, default=300)

    for command in sub.choices.values():
        command.add_argument("--device", default="cuda", help="torch device the trackers and solvers run on (default: cuda)")
    args = parser.parse_args(argv)

    if args.command == "gui":
        from caliscope_tpu_torch.solvers.bundle import not_ported

        raise not_ported("The GUI", "item 26, the GUI")

    from caliscope_tpu_torch.logger import setup_logging
    from caliscope_tpu_torch.workspace import Workspace

    setup_logging(args.workspace / "logs" if args.command != "init" else None)

    if args.command == "init":
        Workspace.create(args.workspace)
        print(f"Initialized workspace at {args.workspace}")
        return 0

    ws = Workspace(args.workspace, device=args.device)

    if args.command == "export-board":
        ch = ws.targets.load_intrinsic_charuco()
        ch.save_image(args.out, px_per_square=args.px_per_square, mirror=args.mirror)
        print(f"Wrote {args.out}")
        return 0

    if args.command == "status":
        st = ws.get_workflow_status()
        print(f"Cameras: {st.camera_count}")
        print(f"  intrinsic calibration: {st.intrinsic_step_status.name}"
              + (f" (need: {st.cameras_needing_calibration})" if st.cameras_needing_calibration else ""))
        print(f"  extrinsic extraction:  {st.extrinsic_2d_step_status.name}")
        print(f"  extrinsic calibration: {st.extrinsic_calibration_step_status.name}")
        print(f"  recordings: {st.recording_names or 'none'}")
        return 0

    if args.command == "calibrate-intrinsics":
        from caliscope_tpu_torch.reporting import print_intrinsic_report

        cams = [args.cam] if args.cam is not None else ws.get_cam_ids()
        for cid in cams:
            out = ws.run_intrinsic_calibration(cid, frame_step=args.frame_step)
            print_intrinsic_report(out)
        return 0

    if args.command == "extract":
        points = ws.extract_extrinsic_points(frame_step=args.frame_step)
        print(f"Extracted {len(points)} observations -> {ws.xy_csv_path(ws.targets.get_extrinsic_tracker_name())}")
        return 0

    if args.command == "calibrate-extrinsics":
        from caliscope_tpu_torch.reporting import print_extrinsic_report

        run = ws.run_extrinsic_calibration(
            refine_intrinsics=not args.no_refine_intrinsics,
            filter_percentile=args.filter_percentile,
        )
        print_extrinsic_report(run)
        return 0

    if args.command == "reconstruct":
        ws.reconstruct_recording(args.recording, frame_step=args.frame_step)
        print(f"Reconstruction written under {ws.recording_dir / args.recording}")
        return 0

    return 1


if __name__ == "__main__":
    # Crash forensics surviving hard faults (a segfault in native code or
    # the CUDA runtime): tracebacks of all threads land in a temp file, as
    # the reference arranges it (reference __main__.py:9-15).
    try:
        faulthandler.enable(open(Path(tempfile.gettempdir()) / "caliscope_tpu_torch_crash.log", "w"))
    except OSError:  # read-only tmp: crash logging is best-effort
        pass
    sys.exit(main())
