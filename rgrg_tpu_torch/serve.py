"""Pipelined batch serving over a directory of X-ray images.

    python -m rgrg_tpu_torch.serve --checkpoint full_model.pt \\
        --tokenizer-dir gpt2/ --image-dir xrays/ --pattern '*.png'

Loads a reference `.pt`/`.pth` or a checkpoint directory
(core/checkpoint.save_checkpoint: a training run's <run_dir>/last or best,
or a bare params tree), serves the images through
serving.generate_reports_pipelined (preprocessing, device work and report
assembly overlap) and writes the reports in the reference's text format.
Runs on the card unless `--device cpu` is given.

`--data-parallel N` serves on N ranks (core/mesh.launch: one card each,
NCCL; with `--device cpu`, N processes on the CPU through gloo), each
rank its shard of every batch; rank 0 alone prints progress and writes
`--output`. The kernels are built once before the ranks start.
"""

from __future__ import annotations

import argparse
import glob
import os
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help="reference .pt/.pth, or a checkpoint directory")
    ap.add_argument("--tokenizer-dir", required=True)
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--pattern", default="*.jpg")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--num-beams", type=int, default=1)
    ap.add_argument("--max-length", type=int, default=300)
    ap.add_argument("--output", default="generated_reports.txt")
    ap.add_argument("--detect-image-chunk", type=int, default=None,
                    help="run the detector over sub-batches of this size "
                         "(bounds its peak memory)")
    ap.add_argument("--weights-int8", nargs="?", const="xla", default="off",
                    choices=("off", "xla", "pallas"),
                    help="serve the decoder's per-layer matmul weights as "
                         "weight-only per-channel int8: 'xla' (the bare flag) "
                         "multiplies by the dequantised weights, 'pallas' reads "
                         "the int8 weights in kernel K4")
    ap.add_argument("--data-parallel", type=int, default=None, metavar="N",
                    help="serve data-parallel over N ranks (one card each; gloo "
                         "processes with --device cpu); batch-size must be a "
                         "multiple of N")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None, cfg=None) -> None:
    """`cfg`: the ModelConfig the checkpoint was built for (default the
    reference's)."""
    args = build_parser().parse_args(argv)
    if args.data_parallel is None:
        _serve(args, cfg, args.device)
        return
    from rgrg_tpu_torch.core import mesh
    from rgrg_tpu_torch.core.device import resolve_device
    device = resolve_device(args.device)
    if device.type == "cuda":
        from rgrg_tpu_torch.ops import kernels
        kernels.build()
    mesh.launch(_serve_rank, args.data_parallel, args=(args, cfg), device=device.type)


def _serve_rank(rank: int, args, cfg) -> None:
    from rgrg_tpu_torch.core import mesh
    _serve(args, cfg, mesh.rank_device(), mesh.make_mesh(args.data_parallel))


def _serve(args, cfg, device, mesh=None) -> None:
    from rgrg_tpu_torch.evaluate import load_generator
    from rgrg_tpu_torch.inference import write_generated_reports_to_txt
    from rgrg_tpu_torch.serving import generate_reports_pipelined

    main = mesh is None or mesh.is_main
    gen = load_generator(args.checkpoint, args.tokenizer_dir, cfg, device)
    if mesh is not None:
        from rgrg_tpu_torch.core.mesh import replicate_pytree
        replicate_pytree(gen.params, mesh)   # every rank serves rank 0's weights
    images = sorted(glob.glob(os.path.join(args.image_dir, args.pattern)))
    if main:
        print(f"{len(images)} images" + (f" on {mesh.size} ranks" if mesh else ""))
    t0 = time.perf_counter()
    reports = []
    for chunk in generate_reports_pipelined(
            gen, images, batch_size=args.batch_size, num_beams=args.num_beams,
            max_length=args.max_length, detect_image_chunk=args.detect_image_chunk,
            mesh=mesh, weights_int8=False if args.weights_int8 == "off" else args.weights_int8):
        reports.extend(chunk)
        done = len(reports)
        if main:
            print(f"{done}/{len(images)}  {done / (time.perf_counter() - t0):.1f} reports/s")
    if main:
        write_generated_reports_to_txt(images, reports, args.output)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
