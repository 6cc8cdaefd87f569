"""Command-line interface of the port.

The counterpart of pyrecode_tpu/cli.py (capability parity with the
reference's argparse entry points, recode_server.py:739-773,
recode_writer.py:655-691, utils/calibration.py:141-169), under one
``pyrecode-tpu-torch`` command:

    python -m pyrecode_tpu_torch server  --image_filename ... --params_file ...
    python -m pyrecode_tpu_torch write   --image_filename ... --params_file ...
    python -m pyrecode_tpu_torch merge   --folder ... --base ... --num_parts N
    python -m pyrecode_tpu_torch read    --file ... [--frame Z]
    python -m pyrecode_tpu_torch calibrate --flatfield_filepath ...

``--device`` ("cuda", the default, or "cpu") is the device of the server,
writer, reader and calibration; ``--no_tpu`` (the JAX CLI's name) takes the
host encode path (``use_tpu=False``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _add_common_writer_args(p):
    p.add_argument("--image_filename", default="", help="source file to process")
    p.add_argument("--calibration_file", dest="calibration_file", default="",
                   help="path to calibration (dark) file")
    p.add_argument("--out_dir", default=".", help="output directory")
    p.add_argument("--params_file", default="", help="path to params file")
    p.add_argument("--mode", default="batch", choices=("batch", "stream"))
    p.add_argument("--directory_path", default="", help="watch dir for stream mode")
    p.add_argument("--validation_frame_gap", type=int, default=-1)
    p.add_argument("--log_file", default="recode.log")
    p.add_argument("--run_name", default="run_1")
    p.add_argument("--verbosity", type=int, default=0)
    p.add_argument("--max_count", type=int, default=-1,
                   help="number of chunks to process in stream mode")
    p.add_argument("--chunk_time_in_sec", type=int, default=1)
    p.add_argument("--no_tpu", action="store_true", help="use the host oracle encode path")
    _add_device_arg(p)


def _add_device_arg(p):
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device of the kernels (cpu runs their plain twins)")


def _init_params_from(args):
    from .params import InitParams

    return InitParams(
        args.mode, args.out_dir, image_filename=args.image_filename,
        directory_path=args.directory_path, calibration_filename=args.calibration_file,
        params_filename=args.params_file, validation_frame_gap=args.validation_frame_gap,
        log_filename=args.log_file, run_name=args.run_name, verbosity=args.verbosity,
        use_tpu=not args.no_tpu, max_count=args.max_count,
        chunk_time_in_sec=args.chunk_time_in_sec)


def cmd_server(args):
    from .server import ReCoDeServer

    server = ReCoDeServer(args.mode, device=args.device)
    metrics = server.run(_init_params_from(args))
    for node_id, m in metrics.items():
        print(f"node {node_id}: {m.get('run_frames', 0)} frames in {m.get('run_time')}")
    return 0


def cmd_write(args):
    from .writer import ReCoDeWriter, print_run_metrics

    writer = ReCoDeWriter(
        args.image_filename, dark_filename=args.calibration_file,
        output_directory=args.out_dir, params_filename=args.params_file,
        mode=args.mode, validation_frame_gap=args.validation_frame_gap,
        log_filename=args.log_file, run_name=args.run_name,
        verbosity=args.verbosity, use_tpu=not args.no_tpu, device=args.device)
    writer.start()
    metrics = writer.run()
    writer.close()
    print_run_metrics(metrics)
    return 0


def cmd_merge(args):
    from .reader import merge_parts

    path = merge_parts(args.folder, args.base, args.num_parts)
    print(path)
    return 0


def cmd_read(args):
    from .reader import ReCoDeReader

    reader = ReCoDeReader(args.file, is_intermediate=args.intermediate, device=args.device)
    reader.open(print_header=True)
    if args.frame >= 0:
        fd = reader.get_frame(args.frame)
        frame = fd[args.frame]["data"]
        print(f"frame {args.frame}: {frame.nnz} foreground pixels, "
              f"sum={frame.sum()}, shape={frame.shape}")
    else:
        shape = reader.get_shape()
        print(f"{shape[0]} frames of {shape[1]}x{shape[2]}")
    reader.close()
    return 0


def cmd_calibrate(args):
    from .utils.calibration import make_calibration_frames

    make_calibration_frames(
        args.filepath, np.uint16, args.n_frames, args.n_stats_frames,
        args.n_sigmas, args.savepath, args.filename_prefix,
        use_acc=args.use_acc, sigma_acc=args.sigma_acc, device=args.device)
    return 0


def build_parser():
    parser = argparse.ArgumentParser(prog="pyrecode-tpu-torch",
                                     description="ReCoDe codec on PyTorch and CUDA")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("server", help="run the multi-node acquisition server")
    _add_common_writer_args(p)
    p.set_defaults(func=cmd_server)

    p = sub.add_parser("write", help="single-node encode")
    _add_common_writer_args(p)
    p.set_defaults(func=cmd_write)

    p = sub.add_parser("merge", help="merge part files into one ReCoDe file")
    p.add_argument("--folder", required=True)
    p.add_argument("--base", required=True, help="base filename, e.g. run.rc1")
    p.add_argument("--num_parts", type=int, required=True)
    p.set_defaults(func=cmd_merge)

    p = sub.add_parser("read", help="inspect / decode a ReCoDe file")
    p.add_argument("--file", required=True)
    p.add_argument("--frame", type=int, default=-1)
    p.add_argument("--intermediate", action="store_true")
    _add_device_arg(p)
    p.set_defaults(func=cmd_read)

    p = sub.add_parser("calibrate", help="build calibration threshold frames")
    p.add_argument("--flatfield_filepath", dest="filepath", required=True)
    p.add_argument("--n_frames", type=int, default=100)
    p.add_argument("--n_stats_frames", type=int, default=10)
    p.add_argument("--n_sigmas", type=int, default=4)
    p.add_argument("--savepath", default="")
    p.add_argument("--save_prefix", dest="filename_prefix", default="")
    p.add_argument("--use_acc", action="store_true")
    p.add_argument("--sigma_acc", type=int, default=3)
    _add_device_arg(p)
    p.set_defaults(func=cmd_calibrate)

    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
