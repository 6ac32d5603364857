"""mustache-tpu: multi-scale chromatin loop detection on JAX.

A from-scratch JAX/XLA reimplementation of the Mustache method
(scale-space difference-of-Gaussians loop calling on Hi-C / Micro-C contact
maps; reference: ay-lab/mustache v1.3.3). Contact maps are tiled into
overlapping diagonal-band blocks, the whole Gaussian scale-space ladder is
evaluated as one batched separable convolution, space/scale non-maximum
suppression runs as a scan over DoG planes, and statistical testing
(exponential-tail p-values + Benjamini-Hochberg FDR) runs fused on device
in log space.
Blocks are data-parallel across a `jax.sharding.Mesh`.
"""

from mustache_tpu._version import __version__
from mustache_tpu.config import DetectionConfig, parse_bp
from mustache_tpu.pipeline import find_loops, Loop


def find_diff_loops(*args, **kwargs):
    """Lazy re-export of :func:`mustache_tpu.diff.find_diff_loops` (the
    diff module pulls in the detection stack; keep base import light)."""
    from mustache_tpu.diff import find_diff_loops as _impl

    return _impl(*args, **kwargs)


__all__ = [
    "__version__",
    "DetectionConfig",
    "parse_bp",
    "find_loops",
    "find_diff_loops",
    "Loop",
]
