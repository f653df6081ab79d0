"""Host seconds of the port's GIF writer for one training.gif.

Decodes the training.gif of the committed H100 evidence set (30 frames of
the btcvae_dsprites traversal grid) with this checkout's reader, then
writes the same frames with the `mimsave` of the
`disvae_tpu_torch/utils/viz_helpers.py` under ROOT (this checkout by
default, or another checkout of the repo, to time its writer on the same
frames). Prints the seconds of each write, the bytes written and, where
`nvidia-smi` is present, the card's name and power limit.

    python tests/gif_encode_timing.py [--root DIR] [--repeat N]
"""

import argparse
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIF = os.path.join(REPO, "artifacts", "btcvae_dsprites_h100", "training.gif")


def _viz_helpers(root, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(
        root, "disvae_tpu_torch", "utils", "viz_helpers.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=REPO,
                        help="checkout whose GIF writer is timed")
    parser.add_argument("--repeat", type=int, default=3)
    args = parser.parse_args(argv)
    frames, _, _ = _viz_helpers(REPO, "reader").read_gif(GIF)
    writer = _viz_helpers(os.path.abspath(args.root), "writer")
    out = tempfile.mkdtemp()
    try:
        path = os.path.join(out, "training.gif")
        seconds = []
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            writer.mimsave(path, frames)
            seconds.append(time.perf_counter() - t0)
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(out)
    smi = None
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    print("[{}] writer of {}: {} frames of {} in {} s, {:,} bytes".format(
        smi, args.root, len(frames), frames[0].shape,
        " / ".join("{:.3f}".format(s) for s in seconds), size))


if __name__ == "__main__":
    sys.exit(main())
