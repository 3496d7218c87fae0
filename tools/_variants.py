"""Build copies of a kernel source, each with its own text substitutions,
and bind each copy's library: the shared step of the tools that read a
kernel's variants side by side on one NVIDIA card.

A substitution quotes the source, so an edit to a quoted line makes the
tool stop with the substitution that no longer matches. Every copy is
compiled with the port's own ``nvcc`` flags (``sm_90a``), all processes
started together.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import build as kbuild  # noqa: E402


def variant_source(tool: str, text: str, subs) -> str:
    """``text`` with each (old, new) substitution made; each ``old`` must
    occur exactly once."""
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"{tool}: substitution does not match: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants(tool: str, source: Path, out: Path, variants: dict, bind):
    """(libs, logs): for each name in ``variants`` (name -> substitutions),
    the library built from ``source`` so changed into ``out``, passed
    through ``bind`` (the wrapper module's argument types), and the
    compiler's log. Stops at the first variant that does not build."""
    out.mkdir(parents=True, exist_ok=True)
    text = source.read_text()
    procs = {}
    for name, subs in variants.items():
        src = out / f"{name}.cu"
        src.write_text(variant_source(tool, text, subs))
        procs[name] = subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, logs = {}, {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{tool}: nvcc failed for {name}:\n{logs[name]}")
        libs[name] = bind(ctypes.CDLL(str(out / f"lib{name}.so")))
    return libs, logs
