"""Profiling and timing utilities.

Port of ``tacex_tpu/utils/profiling.py``:

  * :class:`Timer` — nestable named scopes with a hierarchical report. PyTorch
    returns before the card finishes, so a scope given a CUDA tensor as
    ``fence`` synchronises that tensor's device before it closes (the JAX
    version's ``block_until_ready``);
  * :func:`trace` — a context manager around ``torch.profiler`` that writes a
    Chrome trace (``chrome://tracing``, Perfetto) into a directory;
  * :func:`synchronize` and :func:`device_label` for the benchmark scripts:
    wait for a device, and name it beside its numbers.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch

from ..core.device import DEFAULT_DEVICE, resolve


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_label(device) -> str:
    """``device``'s name beside its numbers: for a card, its name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` prints them (it
    raises if nvidia-smi fails); otherwise the device's type."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()
    return out[dev.index or 0].strip()


def _fence(tree) -> None:
    """Synchronise the device of every CUDA tensor in ``tree`` (a tensor, or
    dicts, lists and tuples of them)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _fence(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _fence(v)


class Timer:
    """Nested scope timer with an aggregated hierarchical report."""

    def __init__(self):
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)
        self._stack: list[str] = []

    @contextlib.contextmanager
    def scope(self, name: str, fence=None):
        """Time a scope. Pass ``fence`` (a tensor, or dicts, lists and tuples
        of them) to wait for the card to finish before closing the scope."""
        path = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                _fence(fence)
            self._totals[path] += time.perf_counter() - t0
            self._counts[path] += 1
            self._stack.pop()

    def report(self, as_json: bool = False):
        entries = {
            path: {
                "total_ms": round(t * 1e3, 3),
                "count": self._counts[path],
                "avg_ms": round(t / max(self._counts[path], 1) * 1e3, 3),
            }
            for path, t in sorted(self._totals.items())
        }
        if as_json:
            return entries
        lines = []
        for path, e in entries.items():
            indent = "  " * path.count("/")
            lines.append(
                f"{indent}{path.split('/')[-1]}: {e['total_ms']:.2f} ms "
                f"({e['count']}x, avg {e['avg_ms']:.2f} ms)"
            )
        return "\n".join(lines)

    def reset(self):
        self._totals.clear()
        self._counts.clear()


@contextlib.contextmanager
def trace(log_dir: str | Path, device=DEFAULT_DEVICE):
    """Profile the block with ``torch.profiler`` (the host's activity, and
    the card's for a CUDA ``device``) and write ``trace.json``, a Chrome
    trace, into ``log_dir``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    cuda = resolve(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))
