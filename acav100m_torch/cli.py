"""Command line for the port's stages, with the JAX package's verbs,
positional arguments and dotted-key overrides:

    python -m acav100m_torch fixtures out_dir [--num_shards=2 --size=64 --labels ...]
    python -m acav100m_torch filter in.tsv out.tsv [--keywords_dir=... --fasttext_model=...]
    python -m acav100m_torch download filtered.tsv out_dir [--source_dir=...]
    python -m acav100m_torch segment video_dir out_dir [--num_clips=3 --backend=auto ...]
    python -m acav100m_torch extract data.media.path=... data.output.path=...
    python -m acav100m_torch cluster data.path=... data.output.path=...
    python -m acav100m_torch select data.path=... data.output.path=...
    python -m acav100m_torch reduce out.csv cache1.csv [cache2.csv ...]
    python -m acav100m_torch convert {slowfast,vggish} in_path out_path [--format ...]
    python -m acav100m_torch retrieval [--dataset gaussian|resnet_pairs|mnist_sound]
        [--grid grid.json] [--out_path ...] [key=value ...]
    python -m acav100m_torch evaluate [--cfg FILE.yaml|FILE.json] [key=value ...]

``filter``, ``download`` and ``segment`` are stages 1-3, host work with the
JAX package's arguments and defaults (``download --source_dir`` copies
local files; without it youtube-dl or yt-dlp fetches, where installed).
``reduce`` appends the chunk caches that ``select chunk_size=N`` writes
(``caches/cache_*``) to ``out.csv``, in sorted order. Stages 4-6 run on
``computation.device`` (default ``cuda``; pass
``computation.device=cpu`` to run on the CPU). ``retrieval`` runs a
correspondence-retrieval experiment (or, with ``--grid``, a grid of them)
and prints its precision, recall and F1; its ``key=value`` overrides are
``run_experiment``'s keywords, ``device`` among them (default ``cuda``).
``evaluate`` runs the evaluation suite (``task=pretrain``: contrastive
pretraining on curated shards; ``task=linear_eval``: a linear head on a
frozen backbone over the ``classify/`` dataset that ``fixtures --labels``
writes) and prints one JSON line; it too runs on ``computation.device``.
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


def cmd_filter(args):
    from .pipeline.metadata_filtering import run_file

    kept, total = run_file(args.in_path, args.out_path, keywords_dir=args.keywords_dir,
                           fasttext_model=args.fasttext_model)
    print(f"Done. {kept}/{total}({100.0 * kept / max(total, 1):.2f}%) lines left")


def cmd_download(args):
    from .pipeline.video_download import run_download

    ok, total = run_download(args.tsv_path, args.out_dir, source_dir=args.source_dir)
    print(f"downloaded {ok}/{total}")


def cmd_segment(args):
    import random

    from .pipeline.clip_segmentation import open_video_backend, segment_video

    rng = random.Random(args.seed)
    count = 0
    for path in sorted(Path(args.video_dir).glob("*.mp4")):
        _, paths = segment_video(
            open_video_backend(path, args.backend), args.out_dir, path.stem,
            num_clips=args.num_clips, sampling=args.sampling,
            cut_random_clips=args.cut_random_clips,
            calc_diversity_with_sum=args.calc_diversity_with_sum, rng=rng)
        count += len(paths)
    print(f"extracted {count} clips to {args.out_dir}")


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


def cmd_retrieval(args):
    """The JAX package's ``retrieval`` verb. Beyond its overrides:
    ``num_workers`` (the ``--grid`` pool's size), which only ``--grid``
    takes."""
    from .retrieval.runner import run_experiment

    kwargs = {}
    for key, val in _overrides(args.overrides).items():
        if isinstance(val, str):  # literal coercion: 0.5 -> float, 3 -> int
            try:
                val = json.loads(val)
            except (ValueError, TypeError):
                pass
        kwargs[key] = val
    if "num_workers" in kwargs and not args.grid:
        raise SystemExit("retrieval: num_workers sizes the --grid pool; "
                         "give it with --grid")
    if args.dataset != "gaussian":
        # real-data protocols (reference image_pair_data.py): synthetic
        # digits stand in for MNIST/CIFAR/FSDD, which are not downloaded;
        # loaders accept any (N,H,W[,3]) arrays
        from .retrieval import features as rf

        nclasses = int(kwargs.pop("nclasses", 6))
        images, labels = rf.synthetic_digits(
            nclasses=nclasses,
            per_class=int(kwargs.pop("per_class", 12)),
        )
        device = kwargs.get("device")
        if args.dataset == "resnet_pairs":
            views = rf.resnet_pair_views(
                images, labels, transform=kwargs.pop("transform", "rotate"),
                device=device)
        else:
            views = rf.mnist_sound_pair_views(images, labels, device=device)
            kwargs.setdefault("pairing", "bipartite")
        kwargs["views"] = views
        kwargs.setdefault("ncentroids", nclasses)
        kwargs.setdefault("clustering_method", "sklearn")
    if args.grid:
        # option-grid mode (reference grid_search.py over
        # search_targets/**/*.json); results pickled per config
        from .retrieval.runner import grid_search, load_option_grid

        num_workers = kwargs.pop("num_workers", None)
        jobs = load_option_grid(args.grid)
        for job in jobs:
            for k, v in kwargs.items():
                if k != "views":
                    job.setdefault(k, v)
        results = grid_search(
            job_kwargs=jobs, out_dir=args.out_path,
            views=kwargs.get("views"), num_workers=num_workers,
        )
        for res in results:
            print(
                f"{res['config']}: precision={res['precision']:.4f} "
                f"recall={res['recall']:.4f} f1={res['f1']:.4f}"
            )
        return
    res = run_experiment(out_path=args.out_path, **kwargs)
    print(
        f"precision={res['precision']:.4f} recall={res['recall']:.4f} "
        f"f1={res['f1']:.4f}"
    )


def cmd_convert(args):
    """torch/caffe2 checkpoint -> flax .npz + sha256 manifest."""
    from .models.zoo import convert_checkpoint

    manifest = convert_checkpoint(args.model, args.in_path, args.out_path,
                                  fmt=args.format)
    print(json.dumps(manifest, indent=1))


def write_fixtures(out_dir, num_shards=2, clips_per_shard=4, size=64, seed=0,
                   labels=False):
    """Synthetic npz clip shards (tar + json per shard), the same bytes as
    the JAX package's ``fixtures`` verb: 32 class-tinted noise frames of
    size x size and 10 s of class-toned 16 kHz audio per clip. With
    ``labels``, also a flat ``ClipClassificationDataset`` in ``classify/``
    (one npz clip of 12 frames and 2 s of audio per shard clip, 4 classes,
    the last 4 clips the test split, and ``labels.json``)."""
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
    if labels:
        cls_dir = out / "classify"
        cls_dir.mkdir(exist_ok=True)
        items = []
        n = num_shards * clips_per_shard
        for i in range(n):
            klass = i % 4
            t = np.arange(int(16000 * 2.0)) / 16000.0
            frames = rng.randint(0, 60, (12, size, size, 3)).astype(np.uint8)
            frames[..., klass % 3] += np.uint8(120)
            audio = (0.4 * np.sin(2 * np.pi * 220.0 * (1 + klass) * t)
                     + 0.05 * rng.randn(len(t))).astype(np.float32)
            fname = f"clip{i:04d}.npz"
            np.savez(cls_dir / fname, frames=frames, audio=audio,
                     sample_rate=16000, video_fps=6.0)
            items.append({"file": fname, "label": klass,
                          "split": "train" if i < max(n - 4, n // 2) else "test"})
        (cls_dir / "labels.json").write_text(json.dumps(
            {"classes": [f"c{k}" for k in range(4)], "items": items}))
    return count


def cmd_fixtures(args):
    count = write_fixtures(args.out_dir, args.num_shards, args.clips_per_shard,
                           args.size, args.seed, labels=args.labels)
    print(f"wrote {args.num_shards} shards ({count} clips) to {args.out_dir}")


def cmd_evaluate(args):
    """Evaluation tasks from a YAML/JSON config and dotted overrides; prints
    the result (without its history) as one JSON line."""
    from .evaluation.config import load_config, run_task

    result = run_task(load_config(args.cfg, _overrides(args.overrides)))
    result.pop("history", None)
    print(json.dumps(result, default=float))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="acav100m_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("filter", help="stage 1: metadata filtering")
    p.add_argument("in_path")
    p.add_argument("out_path")
    p.add_argument("--keywords_dir", default=None)
    p.add_argument("--fasttext_model", default=None)
    p.set_defaults(fn=cmd_filter)

    p = sub.add_parser("download", help="stage 2: video download")
    p.add_argument("tsv_path")
    p.add_argument("out_dir")
    p.add_argument("--source_dir", default=None)
    p.set_defaults(fn=cmd_download)

    p = sub.add_parser("segment", help="stage 3: clip segmentation")
    p.add_argument("video_dir")
    p.add_argument("out_dir")
    p.add_argument("--num_clips", type=int, default=3)
    p.add_argument("--sampling", default="diversity_greedy")
    p.add_argument("--cut_random_clips", type=int, default=None)
    p.add_argument("--calc_diversity_with_sum", action="store_true")
    p.add_argument("--seed", type=int, default=98052)
    p.add_argument("--backend", default="auto", choices=["auto", "native", "ffmpeg", "opencv"])
    p.set_defaults(fn=cmd_segment)

    for verb, fn, help_ in (
        ("extract", cmd_extract, "stage 4: feature extraction"),
        ("cluster", cmd_cluster, "stage 5: k-means clustering"),
        ("select", cmd_select, "stage 6: MI subset selection"),
        ("retrieval", cmd_retrieval, "correspondence-retrieval experiment"),
    ):
        p = sub.add_parser(verb, help=help_)
        p.add_argument("overrides", nargs="*", help="dotted key=value overrides")
        if verb == "retrieval":
            p.add_argument("--out_path", default=None)
            p.add_argument("--dataset", default="gaussian",
                           choices=["gaussian", "resnet_pairs", "mnist_sound"])
            p.add_argument("--grid", default=None,
                           help="option-grid json (reference "
                                "search_targets format or {kwarg: [values]})")
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
    p.add_argument("--labels", action="store_true",
                   help="also write a classify/ ClipClassificationDataset")
    p.set_defaults(fn=cmd_fixtures)

    p = sub.add_parser("evaluate", help="evaluation tasks (pretrain / linear_eval)")
    p.add_argument("--cfg", default=None, help="YAML/JSON config file")
    p.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    p.set_defaults(fn=cmd_evaluate)

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
