#!/usr/bin/env python3
"""Where the decode step's two kernels spend their time, on one CUDA card.

    python3 chip_probe_decode.py

Run from the root of a checkout, on a machine with the CUDA toolkit. It
builds `scoreperformer_tpu_torch/csrc/prefix_attend.cu` and
`scoreperformer_tpu_torch/csrc/kv_cache.cu` as they are ("base") and variants
of each, one edit away, checks every variant against the plain versions,
and times them by CUDA-graph replay in turns (the variants in order, then in
reverse):
- prefix_attend, tile32k: tiles of 32 KB of K rows in place of 16
  (`kTileKBytes`, mirrored by `ops/prefix_attend.py::TILE_K_BYTES`, which
  the probe sets with it: the slots a tile, and so the bytes a ring stage
  holds); stages2: a ring of 2 tiles in place of 3 (`kStages`: the tiles
  in flight a block; 4 stages of 64 fp32 slots at d = 128 pass the 227 KB
  a block can have); threads256: blocks of 8 warps in
  place of 4 (`kThreads`); at the decode paths' shapes (the smoke-shaped,
  flagship and scale_1024 served batches in each cache dtype, the TPU
  script's, the render's);
- write_kv, units1 / units4 / units8: 1, 4 or 8 16-byte units a thread in
  place of 2 (`kUnits`: the loads each thread has in flight); at the decode
  step's pairs (the render's, the served batch's, scale_1024's) and one 2 MB
  write.
Each variant is an exact-text edit of the constant's line, and fails loudly
when the line has changed.
Prints the card's name and power limit, each prefix_attend variant's
registers and spills from ptxas, then one JSON line per kernel, variant,
shape and turn (with the tile, splits and tiles a split of prefix_attend's
plan).
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

PREFIX_SHAPES = [  # (b, cap, base, h, d, dtype): smoke.yaml's decoder, the flagship's, scale_1024's, the
    # TPU script's, the render's
    (128, 384, 192, 2, 16, "fp32"), (128, 384, 192, 4, 64, "fp32"), (128, 384, 192, 4, 64, "bf16"),
    (128, 384, 192, 4, 64, "int8"), (64, 1024, 512, 8, 128, "fp32"), (64, 1024, 512, 8, 128, "int8"),
    (512, 256, 240, 4, 64, "fp32"), (1, 352, 176, 4, 64, "fp32")]
PREFIX_EDGES = [  # checked only: a base below a tile, n_valid = cap at b = 1, uneven splits, MHA
    (128, 384, 5, 4, 64, "bf16", 1), (1, 1024, 1024, 8, 128, "int8", 1), (1, 1024, 1024, 8, 128, "fp32", 1),
    (3, 1024, 517, 8, 128, "fp32", 1), (5, 100, 60, 4, 64, "int8", 4), (7, 300, 300, 2, 16, "bf16", 1)]
WRITE_SHAPES = [  # (cap, n, b, dim, pair): the render's, served and scale_1024 steps; a 2 MB write
    (16, 1, 1, 64, True), (16, 1, 128, 64, True), (16, 1, 32, 128, True), (272, 16, 512, 64, False)]


def edit(text, old, new):
    if old not in text:
        raise AssertionError(f"variant edit does not apply: {old!r}")
    return text.replace(old, new)


def variants(library, cu):
    """name -> (kernel source, each one edit away from `cu`; the value of
    ops/prefix_attend.py::TILE_K_BYTES it needs, or None)."""
    if library == "prefix_attend":
        tile, stages = "constexpr int kTileKBytes = 16384;", "constexpr int kStages = 3;"
        threads = "constexpr int kThreads = 128;"
        return {"base": (cu, 16384),
                "tile32k": (edit(cu, tile, "constexpr int kTileKBytes = 32768;"), 32768),
                "stages2": (edit(cu, stages, "constexpr int kStages = 2;"), 16384),
                "threads256": (edit(cu, threads, "constexpr int kThreads = 256;"), 16384)}
    units = "constexpr int kUnits = 2;"
    return {"base": (cu, None), **{f"units{n}": (edit(cu, units, f"constexpr int kUnits = {n};"), None)
                                   for n in (1, 4, 8)}}


def ptxas_summary(log):
    """{instance: "N registers"} of every prefix_attend_tiles instance in an
    `nvcc -Xptxas=-v` log, and {instance + " spills": ptxas's line} of each
    that spills."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if "prefix_attend_tiles" in m.group(1) else None
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out[name] = regs.group(1) + " registers" if regs else line.strip()
        elif name and "spill" in line:
            spill = re.findall(r"(\d+) bytes spill", line)
            if any(int(x) for x in spill):
                out[name + " spills"] = line.strip()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_decode: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from scoreperformer_tpu_torch.models.attention import quantize_kv_rows
    from scoreperformer_tpu_torch.ops import _build
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    root = _build.BUILD_DIR.parent / "decode_probe"
    shutil.rmtree(root, ignore_errors=True)
    sources = {lib: variants(lib, (_build.CSRC / f"{lib}.cu").read_text()) for lib in ("prefix_attend", "kv_cache")}
    builds = {}
    for lib, by_name in sources.items():
        for name, (cu, _) in by_name.items():
            d = root / lib / name
            d.mkdir(parents=True)
            (d / f"{lib}.cu").write_text(cu)
            builds[lib, name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                                                  "-o", str(d / "lib.so"),
                                                  str(d / f"{lib}.cu")], stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT)
    for (lib, name), proc in builds.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {lib} variant {name}:\n{log}")
        if lib == "prefix_attend":
            print(json.dumps({"kernel": lib, "variant": name, "ptxas": ptxas_summary(log)}))

    def use(lib, name):
        if lib == "prefix_attend":  # the wrapper's tiles follow the variant
            pa.TILE_K_BYTES = sources[lib][name][1]
        so = ctypes.CDLL(str(root / lib / name / "lib.so"))
        for symbol, argtypes in _build.ENTRY_POINTS[lib].items():
            fn = getattr(so, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _build._loaded[(lib, symbol)] = fn

    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    prefix_inputs = []
    for b, cap, base, h, d, dtype in PREFIX_SHAPES:
        q = torch.randn(b, h, d, device="cuda", generator=g) * d**-0.5
        k, v = (torch.randn(cap, b, d, device="cuda", generator=g) for _ in range(2))
        bias = torch.where(torch.arange(cap, device="cuda")[None] < base, 0.0, -1e9).expand(h, cap).contiguous()
        scales = (None, None)
        if dtype == "bf16":
            k, v = k.bfloat16(), v.bfloat16()
        elif dtype == "int8":
            (k, k_s), (v, v_s) = quantize_kv_rows(k), quantize_kv_rows(v)
            scales = (k_s, v_s)
        copies = [(k.clone(), v.clone()) for _ in range(cs.n_copies(2 * base * b * d * k.element_size()))]
        prefix_inputs.append(((b, cap, base, h, d, dtype), q, bias, scales, copies))
    write_inputs = []
    for cap, n, b, dim, pair in WRITE_SHAPES:
        caches = [torch.randn(cap, b, dim, device="cuda", generator=g) for _ in range(2 if pair else 1)]
        news = [torch.randn(n, b, dim, device="cuda", generator=g) for _ in caches]
        copies = [([c.clone() for c in caches], [x.clone() for x in news])
                  for _ in range(cs.n_copies(len(caches) * caches[0].numel() * 4))]
        write_inputs.append(((cap, n, b, dim, pair), copies))
    idx = torch.tensor([5], dtype=torch.int64, device="cuda")

    for lib, by_name in sources.items():
        for name in by_name:  # every variant is right before it is timed
            use(lib, name)
            try:
                if lib == "prefix_attend":
                    for b, cap, base, h, d, dtype in PREFIX_SHAPES:
                        cs.check_prefix_attend(torch, pa, b, cap, base, timed=False, dtype=dtype, h=h, d=d)
                    for b, cap, base, h, d, dtype, kvh in PREFIX_EDGES:
                        cs.check_prefix_attend(torch, pa, b, cap, base, timed=False, dtype=dtype, h=h, d=d, kvh=kvh)
                else:
                    for cap, n, b, dim, pair in WRITE_SHAPES + [(10, 2, 3, 5, True), (16, 1, 128, 64, False)]:
                        for index in (0, 5, -1, cap):
                            for dtype in (torch.float32, torch.bfloat16):
                                cs.check_write_kv(torch, kv, cap, n, b, dim, index, dtype, timed=False, pair=pair)
            except (AssertionError, RuntimeError) as exc:
                raise AssertionError(f"{lib} variant {name}: {exc}") from None
        names = list(by_name)
        for turn, name in enumerate(names + names[::-1]):
            use(lib, name)
            if lib == "prefix_attend":
                for shape, q, bias, scales, copies in prefix_inputs:
                    base = shape[2]
                    ms = cs.graph_ms(torch, lambda kc, vc: pa.prefix_attend(q, kc, vc, bias, *scales, n_valid=base),
                                     copies, iters=200)
                    plan = pa.grid_plan(q.device, shape[0], base, shape[4], shape[3], copies[0][0].dtype)
                    print(json.dumps({"kernel": lib, "variant": name, "turn": turn, "shape": list(shape), "ms": ms,
                                      "tile_splits_per": plan}))
            else:
                for shape, copies in write_inputs:
                    def write(cs_, xs):
                        return kv.write_kv_pair(*cs_, *xs, idx) if len(cs_) == 2 else kv.write_kv(cs_[0], xs[0], idx)

                    ms = cs.graph_ms(torch, write, copies, iters=200)
                    print(json.dumps({"kernel": lib, "variant": name, "turn": turn, "shape": list(shape), "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
