"""Preprocess an h36m-fetch download into the reference pickle schema
(counterpart of links_tpu/cli/preprocess.py; the walk is
``links_tpu_torch.data.preprocess``). Needs h5py: without it the command
exits 2 naming it.

Usage:
    python -m links_tpu_torch.cli.preprocess --h36m-dir <h36m-fetch root>/processed \\
        --out data/h36m_data.pkl
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="h36m-fetch processed/ tree -> reference-schema pickle")
    parser.add_argument("--h36m-dir", default="processed/",
                        help="h36m-fetch 'processed' directory "
                             "(subject/action/annot.h5 layout)")
    parser.add_argument("--out", default="data/h36m_data.pkl",
                        help="output pickle path")
    args = parser.parse_args(argv)
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("links_tpu_torch.cli.preprocess: reading annot.h5 files needs the h5py "
              "package, which is not installed", file=sys.stderr)
        raise SystemExit(2)

    from links_tpu_torch.data.preprocess import preprocess_h36m_fetch

    d = preprocess_h36m_fetch(args.h36m_dir, args.out)
    for s in sorted(d):
        print(f"{s}: {d[s]['poses_2d'].shape[0]} frames")
    print(f"[links_tpu_torch] wrote {args.out}")
    return d


if __name__ == "__main__":
    main()
