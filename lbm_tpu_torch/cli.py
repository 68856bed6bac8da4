"""Command-line interface.

``python -m lbm_tpu_torch run <paramfile> <obstaclefile>`` mirrors the
reference binary's invocation (SerialCode/d2q9-bgk.c:45-52) and its stdout
report (==done==, Reynolds number, phase timings), then writes
``final_state.dat`` and ``av_vels.dat`` (and, with ``--frame-interval``,
``animation_data/``), as ``python -m lbm_tpu run`` does; ``--debug``,
``--checkpoint-every``/``--checkpoint-dir`` and ``--resume`` as there.
``check``, ``bench``, ``info`` and ``scene`` are the other subcommands.

The device is named, never guessed: ``--device cuda`` (the default) needs a
CUDA device and exits 1 with ``Error: no CUDA device`` without one;
``--device cpu`` runs the plain torch code.  Flags and subcommands of
``lbm_tpu`` that this package has not ported yet exit 1 with
``Error: ... not yet ported to lbm_tpu_torch``; none is silently ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# lbm_tpu `run` flags this package does not have yet: dest -> flag.
_UNPORTED_RUN_FLAGS = {
    "plan": "--plan",
    "divergence": "--divergence",
    "profile": "--profile",
    "platform": "--platform",
}
_UNPORTED_COMMANDS = ("viz", "animate", "golden", "sweep", "speedup")


def _add_sharding_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--devices", type=int, default=None,
                   help="shards of the sharded variants (default: every device of the run)")
    p.add_argument(
        "--staleness", type=int, default=None,
        help="halo age of async / chunk length of chunked / exchange depth K of ca "
        "(default: async 1, async-k 2, chunked 2; ca 8 where the in-place engine K8 "
        "holds the shard unsplit, else 4)",
    )
    p.add_argument(
        "--backend", choices=["torch", "cuda", "jnp", "pallas"], default=None,
        help="per-shard step of the sharded variants, or the single-device "
        "variant: cuda (kernels) or torch (plain); jnp/pallas are lbm_tpu's names",
    )
    p.add_argument(
        "--host-devices", type=int, default=None,
        help="make the run's one device (the CPU, or one card) count as N "
        "devices, one shard each",
    )


def _add_run_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("paramfile")
    p.add_argument("obstaclefile")
    p.add_argument(
        "--variant", default="auto",
        help="solver variant: serial | torch | cuda | sync | overlap | async | "
        "async-k | chunked | ca (aliases: jnp -> torch, pallas -> cuda, mpi, "
        "waitall, testall, ...); default auto = cuda on a CUDA device, torch "
        "on cpu, lbm_tpu's sharded rule (ca where it maps) on more than one device",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device to run on (default cuda; exits 1 when there is none)",
    )
    p.add_argument(
        "--storage", choices=["f32", "i16"], default="f32",
        help="state representation: f32, or i16 (int16 fixed-point deviations, "
        "half the bytes; needs the cuda variant, which --variant auto picks)",
    )
    _add_sharding_args(p)
    p.add_argument("--steps", type=int, default=None, help="override maxIters")
    p.add_argument("--out-dir", default=".", help="output directory")
    p.add_argument("--final-state-file", default="final_state.dat")
    p.add_argument("--av-vels-file", default="av_vels.dat")
    p.add_argument("--no-output", action="store_true", help="skip writing result files")
    p.add_argument(
        "--segment-steps", type=int, default=None,
        help="steps per runner call (default: 4000-step segments for longer "
        "runs; 0 = one call for the whole run)",
    )
    p.add_argument(
        "--temporal-k", type=int, default=None,
        help="timesteps advanced per HBM sweep on the single-device block-"
        "kernel path (default: auto by grid size; 1 = disable temporal "
        "blocking)",
    )
    p.add_argument("--frame-interval", type=int, default=None,
                   help="capture |u| every k steps (written to OUT_DIR/animation_data)")
    p.add_argument("--debug", action="store_true",
                   help="print av velocity and total density after every step")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="save a resumable state checkpoint every N steps")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--resume", default=None, help="checkpoint .npz to resume from")
    for dest, flag in _UNPORTED_RUN_FLAGS.items():
        if dest in ("plan", "divergence"):
            p.add_argument(flag, dest=dest, action="store_true", help=argparse.SUPPRESS)
        else:
            p.add_argument(flag, dest=dest, default=None, help=argparse.SUPPRESS)


def cmd_run(args: argparse.Namespace) -> int:
    from lbm_tpu_torch.io import load_scene, write_av_vels, write_final_state
    from lbm_tpu_torch.models.driver import (
        RunConfig,
        device_name,
        resolve_device,
        run_simulation,
    )
    from lbm_tpu_torch.models.variants import NotPortedError

    for dest, flag in _UNPORTED_RUN_FLAGS.items():
        if getattr(args, dest) not in (None, False):
            raise NotPortedError(flag)
    device = resolve_device(args.device)
    scene = load_scene(args.paramfile, args.obstaclefile)
    config = RunConfig(
        variant=args.variant,
        device=args.device,
        num_steps=args.steps,
        segment_steps=args.segment_steps,
        storage=args.storage,
        temporal_k=args.temporal_k,
        num_devices=args.devices,
        staleness=args.staleness,
        backend=args.backend,
        host_devices=args.host_devices,
        frame_interval=args.frame_interval,
        debug=args.debug,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        resume_from=args.resume,
    )
    print(f"lbm_tpu_torch: device={device} ({device_name(device)})")

    result = run_simulation(scene, config)

    print("==done==")
    print(f"Variant:\t\t\t{result.variant}")
    print("Reynolds number:\t\t%.12E" % result.reynolds)
    print(result.timer.report())
    print("Compute rate:\t\t\t%.1f MLUPS" % result.mlups)

    if not args.no_output:
        os.makedirs(args.out_dir, exist_ok=True)
        write_final_state(
            os.path.join(args.out_dir, args.final_state_file),
            result.f,
            scene.obstacles,
            scene.params,
        )
        write_av_vels(os.path.join(args.out_dir, args.av_vels_file), result.av_vels)
        if result.frames is not None:
            from lbm_tpu_torch.tools.animation import write_frame_files

            write_frame_files(os.path.join(args.out_dir, "animation_data"), result.frames,
                              result.frame_steps, scene.params)
    return 0


def cmd_bench(args: argparse.Namespace) -> int:
    from lbm_tpu_torch.models.driver import resolve_device
    from lbm_tpu_torch.tools.bench import run_bench

    resolve_device(args.device)
    report = run_bench(
        grid=args.grid,
        variant=args.variant,
        steps=args.steps,
        repeats=args.repeats,
        device=args.device,
        storage=args.storage,
        devices=args.devices,
        staleness=args.staleness,
        backend=args.backend,
        host_devices=args.host_devices,
    )
    print(json.dumps(report))
    return 0


def cmd_info(args: argparse.Namespace) -> int:
    import torch

    from lbm_tpu_torch.io import native
    from lbm_tpu_torch.ops import _build

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            print(f"  cuda:{i}: {torch.cuda.get_device_name(i)}")
    else:
        print("  no CUDA device")
    try:
        nvcc = _build.nvcc_path()
    except RuntimeError:
        nvcc = "not found"
    built = (_build.build_dir() / _build.LIB_NAME).exists()
    print(f"nvcc: {nvcc}; kernel library: {'built' if built else 'not built (builds at first use)'}")
    print(f"native io: {'available' if native.available() else 'not built (make native)'}")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(prog="lbm_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="run a simulation scene")
    _add_run_args(p_run)

    sub.add_parser("check", help="validate outputs against reference results", add_help=False)
    sub.add_parser("scene", help="generate a scene (cavity/channel/cylinder)", add_help=False)

    p_bench = sub.add_parser("bench", help="benchmark a grid/variant")
    p_bench.add_argument("--grid", default="1024x1024")
    p_bench.add_argument("--variant", default="auto")
    p_bench.add_argument("--steps", type=int, default=None)
    p_bench.add_argument("--repeats", type=int, default=3)
    p_bench.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p_bench.add_argument("--storage", choices=["f32", "i16"], default="f32")
    _add_sharding_args(p_bench)

    sub.add_parser("info", help="print device/runtime info")

    # `check` and `scene` forward unparsed args to their own parsers.
    if argv and argv[0] == "check":
        from lbm_tpu_torch.tools.check import main as check_main

        return check_main(argv[1:])
    if argv and argv[0] == "scene":
        from lbm_tpu_torch.tools.scenegen import main as scene_main

        try:
            return scene_main(argv[1:])
        except (OSError, ValueError) as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
    if argv and argv[0] in _UNPORTED_COMMANDS:
        print(f"Error: the {argv[0]!r} command is not yet ported to lbm_tpu_torch",
              file=sys.stderr)
        return 1

    args = parser.parse_args(argv)
    handler = {"run": cmd_run, "bench": cmd_bench, "info": cmd_info}[args.command]
    try:
        return handler(args)
    except (OSError, ValueError) as e:
        # The reference die()s with a message and exit(1)
        # (SerialCode/d2q9-bgk.c:745-751).
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
