"""Stage 2 — video download (filtered.tsv -> raw mp4s).

A copy of ``acav100m_tpu/pipeline/video_download.py`` (the port imports nothing of
the JAX package).

Rebuild of ``video_download/code/run.py:26-41``: one yt-dlp/youtube-dl
fetch per row, mp4 merge, skip-if-exists, swallow download errors. Download
is inherently host/network work; without network access the stage
degrades to the ``copy`` backend (local source directory), which the tests
use.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import Iterator, List, Optional, Tuple


class DownloadFailed(Exception):
    """A fetch backend's 'this download failed' signal.

    The reference swallows exactly ``youtube_dl.utils.DownloadError``
    (run.py:36-37) and lets every other exception propagate; injected
    ``fetch_fn`` backends raise this (or return False) to report a failed
    fetch — any OTHER exception from a backend is a bug and propagates."""


def parse_vid(url: str) -> str:
    """Lenient video-id parse: the ``v=`` query parameter, else the url
    basename. NB deliberate divergence from the reference, which takes
    ``url[-11:]`` (run.py:16-23) — identical on canonical
    ``watch?v=<11 chars>`` urls, but this parser also handles trailing
    query params (``watch?v=ID&t=5``) and non-YouTube/local ids, which the
    offline backends feed it. ``load_urls`` is the reference-exact,
    oracle-verified spec (tests/test_video_download_reference_parity.py)."""
    return url.split("v=")[-1].split("&")[0] if "v=" in url else Path(url).name


def iter_video_ids(tsv_path) -> Iterator[Tuple[str, str]]:
    """(url, vid) per row; vid via the lenient ``parse_vid``."""
    with open(tsv_path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if not parts or not parts[0]:
                continue
            url = parts[0]
            yield url, parse_vid(url)


def load_urls(tsv_path) -> "dict[str, str]":
    """{vid: url} with the reference's exact semantics (run.py:16-23):
    first tab field is the url, vid is its last 11 characters (the YouTube
    watch id), and the dict keying dedupes repeated ids — each vid is
    attempted at most once per run."""
    urls: "dict[str, str]" = {}
    with open(tsv_path) as f:
        for line in f:
            url = line.split("\t")[0]
            if url:
                urls[url[-11:]] = url
    return urls


def load_urls_lenient(tsv_path) -> "dict[str, str]":
    """{vid: url} with the reference's DICT semantics (duplicate vids
    collapse, the LAST url for a vid wins — ``urls[vid] = url`` overwrite,
    run.py:16-23) but the lenient ``parse_vid`` id parse (see its
    docstring for the documented divergence)."""
    urls: "dict[str, str]" = {}
    for url, vid in iter_video_ids(tsv_path):
        urls[vid] = url
    return urls


def find_downloader() -> Optional[List[str]]:
    for cand in ("yt-dlp", "youtube-dl"):
        exe = shutil.which(cand)
        if exe:
            return [exe]
    return None


def download_one(url: str, out_path: Path, downloader: List[str]) -> bool:
    if out_path.is_file():
        return True
    cmd = downloader + [
        "-f", "mp4", "--merge-output-format", "mp4",
        "-o", str(out_path), url,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=600)
        return proc.returncode == 0 and out_path.is_file()
    except Exception:
        return False


def run_download(tsv_path, out_dir, source_dir=None,
                 fetch_fn=None) -> Tuple[int, int]:
    """Download every row's video to ``out_dir``; skip existing, swallow
    download failures, one attempt per vid. Driven from a vid-keyed dict
    exactly like the reference (run.py:16-41): duplicate vids collapse and
    the LAST url for a vid is the one attempted (dict overwrite), verified
    against the reference's own run.py in
    tests/test_video_download_reference_parity.py. Id parse is the lenient
    ``parse_vid`` (divergence documented there). ``source_dir`` enables
    the offline copy backend; ``fetch_fn(url, out_path) -> bool`` injects
    a fetch backend (raise ``DownloadFailed`` or return False on failure —
    other exceptions propagate, mirroring the reference's
    DownloadError-only swallow). Returns (ok, total distinct vids)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    downloader = None if fetch_fn is not None else find_downloader()
    ok = total = 0
    for vid, url in load_urls_lenient(tsv_path).items():
        total += 1
        out_path = out_dir / f"{vid}.mp4"
        if out_path.is_file():
            ok += 1
            continue
        if fetch_fn is not None:
            try:
                if fetch_fn(url, out_path) and out_path.is_file():
                    ok += 1
            except DownloadFailed:
                pass  # swallow download failures (run.py:36-37)
            continue
        if source_dir is not None:
            src = Path(source_dir) / f"{vid}.mp4"
            if src.is_file():
                shutil.copy(src, out_path)
                ok += 1
            continue
        if downloader is None:
            continue  # no network tooling: skip-and-continue
        if download_one(url, out_path, downloader):
            ok += 1
    return ok, total
