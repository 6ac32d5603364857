#!/usr/bin/env python3
"""Reduce a GPU profiler trace of the detector to per-layer device times.

    python3 tools/trace_reduce.py <trace.xplane.pb> <detector.hlo.txt> ...

Each kernel event on a device stream carries the HLO instruction it runs
(``hlo_op``, or ``command_buffer`` inside a CUDA graph, where the kernel's
own name is its fusion's) and its module (``hlo_module``). The detector's
compiled HLO text maps every instruction to its ``jax.named_scope`` through the
``op_name`` metadata: ``blur_ladder`` (Gaussian ladder + band shear),
``dog_nms_scan`` (DoG planes, 3x3x3 NMS, per-plane fits) and
``bh_epilogue`` (BH FDR, candidate table, filters). Kernels of other
modules (band normalize, transfers) and unscoped detector ops count as
``other``. Prints one JSON object: device time per layer, busy time (the
union of kernel intervals), the window, and the top kernels of each layer.
"""

import collections
import json
import re
import sys

SCOPES = ("blur_ladder", "dog_nms_scan", "bh_epilogue")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?"
                    r"op_name=\"([^\"]*)\"")


def scope_map(hlo_texts) -> dict:
    """``module -> {HLO instruction name -> layer}`` from compiled HLO
    text (instruction names are unique within a module only)."""
    out = {}
    for text in hlo_texts:
        head = re.match(r"\s*HloModule\s+([\w.\-]+)", text)
        names = out.setdefault(head.group(1) if head else "", {})
        for line in text.splitlines():
            m = _INSTR.match(line)
            if not m:
                continue
            name, op_name = m.groups()
            # scopes show as path parts, wrapped when vmapped:
            # "jit(f)/vmap(blur_ladder)/conv_general_dilated"
            layer = next((s for s in SCOPES if s in op_name), "other")
            names.setdefault(name, layer)
            # kernels XLA emits are named after their fusion, with '.'
            # and '-' turned into '_' ("loop_select_fusion_1")
            names.setdefault(re.sub(r"[.\-]", "_", name), layer)
    return out


def _union(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(xplane_path: str, hlo_texts) -> dict:
    from jax.profiler import ProfileData

    layers = scope_map(hlo_texts)
    pd = ProfileData.from_file(xplane_path)
    per_layer = collections.Counter()
    top = collections.defaultdict(collections.Counter)
    intervals, lo, hi = [], None, None
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = [ln for ln in plane.lines if ln.name.startswith("Stream")]
        for line in lines:
            for ev in line.events:
                st = dict(ev.stats)
                op = str(st.get("hlo_op", ""))
                mod = str(st.get("hlo_module", ""))
                dur = int(ev.duration_ns)
                start = int(ev.start_ns)
                intervals.append((start, start + dur))
                lo = start if lo is None else min(lo, start)
                hi = start + dur if hi is None else max(hi, start + dur)
                # inside a CUDA-graph command buffer the event's hlo_op is
                # "command_buffer"; the kernel name then names the fusion
                names = layers.get(mod, {})
                layer = names.get(op) or names.get(ev.name, "other")
                per_layer[layer] += dur
                top[layer][ev.name[:90]] += dur
    busy = _union(intervals)
    return {
        "device_ns": dict(per_layer),
        "busy_ns": busy,
        "window_ns": (hi - lo) if intervals else 0,
        "kernels": len(intervals),
        "top": {k: v.most_common(8) for k, v in top.items()},
    }


def main(argv):
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    texts = [open(p).read() for p in argv[1:]]
    print(json.dumps(reduce_trace(argv[0], texts), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
