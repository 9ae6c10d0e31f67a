"""What the port's entry points share: the device a run names beside the
card's power limit, the timed window of one batch, the kernels' launch
counts, and where a record is written."""

import os
import subprocess
import time
from pathlib import Path

import torch

from ..index import merge_cuda, merge_packed_cuda, pending_cuda

REPO = Path(__file__).resolve().parents[2]
OUT_DIR = REPO / "smoke_out"


def device_label(dev: torch.device) -> str:
    """"cuda:<card name>" or "cpu": the device every result names."""
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


def power_limit(dev: torch.device):
    """The card's power limit as nvidia-smi prints it ("700.00 W"), or
    None on the CPU or when nvidia-smi cannot say."""
    if dev.type != "cuda":
        return None
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={idx}", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out or None


def sync(dev):
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_insert(eng, reads):
    """(wall s, counts) of one batch: the host clock around insert_multi,
    closed by a device synchronisation and counts() (bench.py:89-98)."""
    sync(eng.device)
    t0 = time.perf_counter()
    eng.insert_multi(reads)
    sync(eng.device)
    cnt = eng.counts()
    return time.perf_counter() - t0, cnt


def launch_counts() -> dict:
    """Launches of kernels A, B and C by this process so far."""
    return {"merge": merge_cuda.LAUNCHES,
            "pending_merge": pending_cuda.LAUNCHES,
            "merge_packed": merge_packed_cuda.LAUNCHES}


def launches_since(before: dict) -> dict:
    """Launches of A, B and C since ``before`` (a launch_counts())."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def out_path(var: str, name: str) -> Path:
    """The record's path: the environment variable ``var`` if it is set,
    else smoke_out/<name> in the checkout (never a committed record)."""
    p = Path(os.environ.get(var) or OUT_DIR / name)
    p.parent.mkdir(parents=True, exist_ok=True)
    return p
