#!/usr/bin/env python3
"""Measure the TPE scoring kernels (``src/repro_torch/kernels/tpe_kde``) on
one NVIDIA GPU against another tree's version of the same source and against
other block shapes of this one.

    python3 scripts/tpe_kde_bench.py --parent build/parent \\
        --variants NT=128,ILP=16+PREFETCH_RMAX=8 --out build/tpe_bench

* ``--parent DIR``: the root of another checkout (e.g. ``git archive`` of
  the parent commit unpacked under the git-ignored ``build/``).  Its
  ``tpe_kde.cu`` is built beside this tree's and both are run in one
  process on the same inputs at every shape of
  ``chip_smoke.TPE_KERNEL_SHAPES``; the script prints the number of output
  elements whose bits differ, then times both at each shape in the order
  parent, this tree, this tree, parent.
* ``--variants SPEC,...``: this tree's source with some of its constants
  replaced, each SPEC ``NAME=VALUE[+NAME=VALUE...]`` for NAME in ``NT``
  (threads per block), ``RMAX`` (most candidates per thread), ``ILP``
  (exponentials a loop trip), ``PREFETCH_RMAX`` (most candidates per thread
  that read the next step ahead) and ``MINB`` (blocks an SM asked of ptxas
  at R >= 4 in place of one), e.g. ``NT=128+ILP=16``; each is built into
  ``build/``, checked bitwise against this tree and timed at every shape.
* the card's SM clock and power draw, read by ``nvidia-smi`` while this
  tree's ``tpe_scores`` runs back to back at the fleet shape.
* the SASS of every library (``cuobjdump -sass``) goes to ``--out``; for
  each kernel the script finds the innermost loops that issue ``MUFU.EX2``
  and prints their instructions per exponential (one per element) with the
  opcode counts.

Times are CUDA-event means over ``--reps`` launches at the fleet shape (100
at the others, whose calls take tens of microseconds) after a warm-up; every
timing line carries the card's name and power limit.  Exits non-zero if a
build fails or a CUDA call errs; differing bits are reported, not fatal.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.tpe_kde import ops as tpe_ops  # noqa: E402

KERNELS = {"tpe_scores": "ILb0E", "parzen_logdens": "ILb1E"}
_FNS = ("tpe_scores", "tpe_parzen_logdens", "tpe_error_string")


def variant_source(spec: str) -> str:
    """This tree's tpe_kde.cu with the constants of ``spec`` replaced."""
    src = tpe_ops.SOURCES[0].read_text()
    for item in spec.split("+"):
        name, value = item.split("=")
        if name == "MINB":
            old = "__launch_bounds__(NT, 1)"
            new = f"__launch_bounds__(NT, R >= 4 ? {int(value)} : 1)"
        else:
            m = re.search(rf"constexpr int {name} = \d+;", src)
            if m is None:
                raise ValueError(f"no constant {name} in tpe_kde.cu")
            old, new = m.group(0), f"constexpr int {name} = {int(value)};"
        if old not in src:
            raise ValueError(f"{old!r} is not in tpe_kde.cu")
        src = src.replace(old, new)
    return src


def build_variant(spec: str) -> ctypes.CDLL:
    """``variant_source(spec)`` built into ``build/``; prints what ptxas said
    of its registers."""
    tag = "tpe_kde-" + re.sub(r"[^A-Za-z0-9]+", "_", spec)
    src = build.BUILD_DIR / f"{tag}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(variant_source(spec))
    out = src.with_suffix(".so")
    proc = subprocess.run(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {spec}:\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line:
            print(f"[ptxas] {spec}: {line.strip()}", flush=True)
    return tpe_ops.bind(ctypes.CDLL(str(out)))


def clock_under_load(fn, launches: int = 3000) -> str:
    """nvidia-smi's SM clock, power draw and temperature, read three times
    while ``launches`` calls of ``fn`` are queued on the card."""
    for _ in range(launches):
        fn()
    reads = [subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
        for _ in range(3)]
    torch.cuda.synchronize()
    return " | ".join(reads)


def build_parent(root: Path, typed: ctypes.CDLL) -> ctypes.CDLL:
    src = root / "src/repro_torch/kernels/tpe_kde/csrc/tpe_kde.cu"
    lib = build.load("tpe_kde_parent", (src,))
    for fn in _FNS:
        getattr(lib, fn).argtypes = getattr(typed, fn).argtypes
        getattr(lib, fn).restype = getattr(typed, fn).restype
    return lib


def run(lib, name, g, d):
    """One launch of kernel ``name`` from ``lib`` on system ``g``."""
    args = g["tpe"] if name == "tpe_scores" else g["parzen"]
    B, S = args[0].shape[:2]
    na, dp = args[1].shape[1:]
    out = torch.empty((B, S), dtype=torch.float32, device=args[0].device)
    fn = lib.tpe_scores if name == "tpe_scores" else lib.tpe_parzen_logdens
    err = fn(*[t.data_ptr() for t in args], out.data_ptr(), B, S, na, dp, d,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: {lib.tpe_error_string(err).decode()}")
    return out


def differing(x, y) -> int:
    return int((x.view(torch.int32) != y.view(torch.int32)).sum().cpu())


def sass_loops(body: str):
    """The innermost loops of one function's SASS that issue MUFU.EX2:
    [(instructions, MUFU.EX2 count, opcode counts)]."""
    ins = []
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body):
        text = m.group(2).strip()
        op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
        tgt = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
        ins.append((int(m.group(1), 16), op,
                    int(tgt.group(1), 16) if tgt else None))
    loops = [(t, a) for a, _, t in ins if t is not None and t <= a]
    inner = [(t, a) for t, a in loops
             if not any(t <= t2 and a2 <= a and (t2, a2) != (t, a)
                        for t2, a2 in loops)]
    out = []
    for t, a in inner:
        ops = collections.Counter(op for addr, op, _ in ins
                                  if t <= addr <= a and op != "NOP")
        if ops["MUFU.EX2"]:
            out.append((sum(ops.values()), ops["MUFU.EX2"], ops))
    return out


def report_sass(tag: str, lib_path: Path, out_dir: Path) -> None:
    """Each kernel instantiation's innermost exponential loops, counted
    from ``cuobjdump -sass`` of the library (saved to ``out_dir``)."""
    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    (out_dir / f"{tag}.sass").write_text(sass)
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        mangled = func.split()[0]
        if "tpe_kde_kernel" not in mangled:
            continue
        name = next(k for k, v in KERNELS.items() if v in mangled)
        r = re.search(r"ILb[01]ELi(\d+)E", mangled)
        name += f" R={r.group(1)}" if r else ""
        for n_ins, n_ex2, ops in sass_loops(func):
            top = ", ".join(f"{op} {c}" for op, c in ops.most_common())
            print(f"[sass] {tag} {name}: inner loop {n_ins} instructions, "
                  f"{n_ex2} MUFU.EX2 -> {n_ins / n_ex2:.2f} per element; "
                  f"{top}", flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--variants", default="")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "tpe_bench")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tpe_kde_bench: no CUDA device available", file=sys.stderr)
        return 2
    args.out.mkdir(parents=True, exist_ok=True)
    card = chip_smoke.card_line()
    print(f"[bench] {card}", flush=True)
    specs = [v for v in args.variants.split(",") if v]
    with ThreadPoolExecutor(max_workers=len(specs) + 1) as pool:
        change = pool.submit(tpe_ops.library)
        variants = {v: pool.submit(build_variant, v) for v in specs}
        change = change.result()
        variants = {k: f.result() for k, f in variants.items()}
    libs = {"change": change, **variants}
    if args.parent:
        libs["parent"] = build_parent(args.parent.resolve(), change)
    for tag, lib in libs.items():
        report_sass(tag, Path(lib._name), args.out)

    dev = torch.device("cuda")
    for tag, B, S, na, n_live, d, kind in chip_smoke.TPE_KERNEL_SHAPES:
        g = chip_smoke.tpe_system(B, S, na, n_live, d, dev, kind=kind)
        for name in KERNELS:
            want = run(change, name, g, d)
            for other, lib in libs.items():
                if other != "change":
                    n_diff = differing(run(lib, name, g, d), want)
                    print(f"[bitwise] {tag} {name}: {other} vs change "
                          f"{n_diff} of {want.numel()} elements differ",
                          flush=True)
        order = ["parent", "change", "change", "parent"] \
            if args.parent else ["change", "change"]
        order += list(variants)
        for name in KERNELS:
            for other in order:
                ms = chip_smoke.cuda_ms(
                    lambda: run(libs[other], name, g, d),
                    args.reps if tag == "fleet" else 100)
                print(f"[time] {tag} {name} {other}: {ms:.4f} ms "
                      f"({card})", flush=True)
        if tag == "fleet":
            print("[clock] tpe_scores back to back at the fleet shape: "
                  "clocks.sm, clocks.max.sm, power.draw, temperature: "
                  + clock_under_load(lambda: run(change, "tpe_scores", g,
                                                 d)), flush=True)
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
