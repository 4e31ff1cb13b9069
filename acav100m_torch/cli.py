"""Command line for the port's stages, with the JAX package's verbs,
positional arguments and dotted-key overrides:

    python -m acav100m_torch fixtures out_dir [--num_shards=2 --size=64 ...]
    python -m acav100m_torch extract data.media.path=... data.output.path=...
    python -m acav100m_torch cluster data.path=... data.output.path=...
    python -m acav100m_torch select data.path=... data.output.path=...
    python -m acav100m_torch reduce out.csv cache1.csv [cache2.csv ...]
    python -m acav100m_torch convert {slowfast,vggish} in_path out_path [--format ...]

``reduce`` appends the chunk caches that ``select chunk_size=N`` writes
(``caches/cache_*``) to ``out.csv``, in sorted order. Every stage runs on
``computation.device`` (default ``cuda``; pass
``computation.device=cpu`` to run on the CPU).
"""

from __future__ import annotations

import argparse
import io
import json
import tarfile
from pathlib import Path

import numpy as np

from .config import parse_overrides


def _overrides(tokens):
    return parse_overrides([t for t in tokens if "=" in t])


def cmd_extract(args):
    from .pipeline.feature_extraction import get_config, run_extraction

    saved = run_extraction(get_config(_overrides(args.overrides)))
    print(f"saved {len(saved)} feature shards")


def cmd_cluster(args):
    from .pipeline.clustering import get_config, run_clustering

    saved = run_clustering(get_config(_overrides(args.overrides)))
    print(f"saved {len(saved)} assignment shards")


def cmd_select(args):
    from .pipeline.subset_selection import get_config, run

    out_path, count = run(get_config(_overrides(args.overrides)))
    print(f"Saved Results: added {count} lines to {out_path}")


def cmd_reduce(args):
    from .utils.io import merge_csvs

    count = merge_csvs(args.caches, args.out_path)
    print(f"merged {count} lines into {args.out_path}")


def cmd_convert(args):
    """torch/caffe2 checkpoint -> flax .npz + sha256 manifest."""
    from .models.zoo import convert_checkpoint

    manifest = convert_checkpoint(args.model, args.in_path, args.out_path,
                                  fmt=args.format)
    print(json.dumps(manifest, indent=1))


def write_fixtures(out_dir, num_shards=2, clips_per_shard=4, size=64, seed=0):
    """Synthetic npz clip shards (tar + json per shard), the same bytes as
    the JAX package's ``fixtures`` verb: 32 class-tinted noise frames of
    size x size and 10 s of class-toned 16 kHz audio per clip."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    count = 0
    for si in range(num_shards):
        meta = []
        with tarfile.open(out / f"shard-{si:06d}.tar", "w") as tf:
            for ci in range(clips_per_shard):
                t = np.arange(int(16000 * 10.0)) / 16000.0
                klass = count % 4
                frames = rng.randint(0, 60, (32, size, size, 3)).astype(np.uint8)
                frames[..., klass % 3] += np.uint8(120)
                audio = (0.4 * np.sin(2 * np.pi * 220.0 * (1 + klass) * t)
                         + 0.05 * rng.randn(len(t))).astype(np.float32)
                buf = io.BytesIO()
                np.savez(buf, frames=frames, audio=audio, sample_rate=16000,
                         video_fps=3.2)
                data = buf.getvalue()
                fname = f"clip_{si:03d}_{ci:03d}.npz"
                info = tarfile.TarInfo(fname)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
                meta.append({"filename": fname, "id": f"vid{count:06d}",
                             "segment": [float(ci), float(ci) + 10.0]})
                count += 1
        (out / f"shard-{si:06d}.json").write_text(json.dumps(meta))
    return count


def cmd_fixtures(args):
    count = write_fixtures(args.out_dir, args.num_shards, args.clips_per_shard,
                           args.size, args.seed)
    print(f"wrote {args.num_shards} shards ({count} clips) to {args.out_dir}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="acav100m_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)
    for verb, fn, help_ in (
        ("extract", cmd_extract, "stage 4: feature extraction"),
        ("cluster", cmd_cluster, "stage 5: k-means clustering"),
        ("select", cmd_select, "stage 6: MI subset selection"),
    ):
        p = sub.add_parser(verb, help=help_)
        p.add_argument("overrides", nargs="*", help="dotted key=value overrides")
        p.set_defaults(fn=fn)

    p = sub.add_parser("reduce", help="merge chunk cache csvs")
    p.add_argument("out_path")
    p.add_argument("caches", nargs="+")
    p.set_defaults(fn=cmd_reduce)

    p = sub.add_parser("fixtures", help="generate synthetic clip shards")
    p.add_argument("out_dir")
    p.add_argument("--num_shards", type=int, default=2)
    p.add_argument("--clips_per_shard", type=int, default=4)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_fixtures)

    p = sub.add_parser("convert", help="convert a torch/caffe2 checkpoint to flax npz")
    p.add_argument("model", choices=["slowfast", "vggish"])
    p.add_argument("in_path")
    p.add_argument("out_path")
    p.add_argument("--format", default=None, choices=["pyslowfast", "caffe2", "vggish"])
    p.set_defaults(fn=cmd_convert)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
