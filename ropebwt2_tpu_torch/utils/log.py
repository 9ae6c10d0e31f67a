"""Logging/timing in the reference's stderr style (main.c:65-78,239-258):
lines tagged [M::func] / [E::func], wall + CPU time helpers."""

import os
import resource
import sys
import time

VERBOSE = 3


def set_verbosity(v: int):
    global VERBOSE
    VERBOSE = v


def realtime() -> float:
    return time.time()


def cputime() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    rc = resource.getrusage(resource.RUSAGE_CHILDREN)
    return r.ru_utime + r.ru_stime + rc.ru_utime + rc.ru_stime


def peak_rss_gb() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_maxrss / 1024.0 / 1024.0  # KiB on Linux


def message(func: str, fmt: str, *args, min_verbose: int = 3):
    if VERBOSE >= min_verbose:
        print(f"[M::{func}] " + (fmt % args if args else fmt), file=sys.stderr)


def error(func: str, fmt: str, *args):
    print(f"[E::{func}] " + (fmt % args if args else fmt), file=sys.stderr)


def liftrlimit():
    """Raise the address-space soft limit to the hard limit (main.c:55-63)."""
    if sys.platform.startswith("linux"):
        try:
            soft, hard = resource.getrlimit(resource.RLIMIT_AS)
            if soft != hard:
                resource.setrlimit(resource.RLIMIT_AS, (hard, hard))
        except (ValueError, OSError):
            pass
