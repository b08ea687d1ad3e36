"""Pack the train split into the native loader's LNKS format (counterpart
of links_tpu/cli/pack_data.py, ``links-pack``), or inspect a pack.

The trainers' ``--packed-data`` streams its batches from such a file
(data/native_loader.py, train/feed.py); they pack it on first use, and this
tool does it once, ahead of them. Its JSON line has the JAX tool's keys.

Usage:
    python -m links_tpu_torch.cli.pack_data --data data/h36m_data.pkl --out train2d.lnks
    python -m links_tpu_torch.cli.pack_data --inspect train2d.lnks
"""

from __future__ import annotations

import argparse
import json

from links_tpu_torch.cli import _common as C
from links_tpu_torch.data import native_loader


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Pack 2D training poses into a native LNKS file (PyTorch port)")
    parser.add_argument("--out", default=None, help="output .lnks path")
    parser.add_argument("--what", choices=["poses_2d", "poses_3d"], default="poses_2d",
                        help="which normalized array of the train split to pack")
    parser.add_argument("--inspect", default=None, metavar="LNKS",
                        help="print the header and row statistics of an existing pack "
                             "instead of packing")
    C.add_common_flags(parser)
    args = parser.parse_args(argv)

    if args.inspect:
        with native_loader.PackedDataset(args.inspect) as ds:
            head = ds.gather(0, min(ds.n_rows, 1024))
            info = {"path": args.inspect, "n_rows": ds.n_rows, "n_cols": ds.n_cols,
                    "native": True, "head_mean": round(float(head.mean()), 6),
                    "head_std": round(float(head.std()), 6)}
        print(json.dumps(info))
        return info
    if not args.out:
        raise SystemExit("--out is required to pack (or use --inspect)")
    arr = getattr(C.load_train(args), args.what).numpy()  # (N, 34) or (N, 51)
    native_loader.pack_dataset(args.out, arr)
    info = {"out": args.out, "what": args.what, "n_rows": int(arr.shape[0]),
            "n_cols": int(arr.shape[1]), "native": True}
    print(json.dumps(info))
    return info


if __name__ == "__main__":
    main()
