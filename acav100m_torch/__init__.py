"""acav100m_torch — the PyTorch/CUDA port of the ACAV100M curation pipeline.

A second package beside ``acav100m_tpu`` (the JAX reference). It keeps the
same stage verbs, config keys, defaults and on-disk contracts (feature
pkls, ``_cache.pkl``, ``cache_epoch_*`` centroid caches, assignment pkls,
``log_*.json`` manifests, ``output.csv``), so either package can resume the
other's run. It imports ``torch``, ``numpy`` and ``scipy`` only: the
framework-free modules it needs from the JAX package are copied, not
imported.

Subpackages
-----------
config      nested config with dotted-key overrides (copy)
device      resolves ``computation.device`` (default ``cuda``)
utils       braceexpand, shard planning, run manifests, IO schemas (copies)
data        clip decoders (npz; mp4 through FFmpeg's libraries, the ffmpeg
            binary or OpenCV), the native tar index, tar shard streaming,
            pooled spawned decode workers over shared memory, prefetch
ops         k-means, MI measures, log-mel front end, and the two hand-written
            CUDA kernels (``kmeans_kernel``, ``bottleneck_kernel``)
models      SlowFast 8x8 R50 and VGGish with PySlowFast/torchvggish names;
            ``zoo``: PySlowFast, caffe2 and torchvggish checkpoints to the
            flax npz format (the ``convert`` verb)
pipeline    stage drivers: extract (4), cluster (5), select (6, with chunk
            mode and every measure), and contrastive selection
"""

__version__ = "0.1.0"
