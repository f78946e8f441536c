#!/usr/bin/env python3
"""Where the flash backward kernels' time goes, on one CUDA card.

    python3 chip_probe_flash_bwd.py

Run from the root of a checkout, on a machine with the CUDA toolkit. It
builds `scoreperformer_tpu_torch/csrc/flash_attention_bwd.cu` as it is
("base") and three variants of it, each one edit away, and times both
kernels of each at the training step's shapes by CUDA-graph replay, in
turns (base, one_mma, no_loop, one_group, then back in reverse order):
- one_mma: one TF32 MMA a product in place of the split's three (wrong by
  design): the share of the time that the MMA chains take;
- no_loop: the tile loops removed (wrong by design): what the set-up and
  the write-back alone take;
- one_group: the dK/dV kernel with one warp group a block (right): what the
  second group buys.
The base and one_group kernels are checked against the plain versions
first. Prints the card's name and power limit, then one JSON line per
variant, shape and turn.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

SHAPES = [  # (b, t, causal, padded): the train step's encoders and decoder, and no padding
    (128, 258, False, True), (128, 257, True, True), (128, 258, False, False)]


def variants(cu, cuh):
    """name -> (kernel source, header source)."""
    def edit(text, old, new):
        if old not in text:
            raise AssertionError(f"variant edit does not apply: {old!r}")
        return text.replace(old, new)

    no_loop = edit(edit(cu, "while (item < n_items) {", "while (false && item < n_items) {"),
                   "while (tile < end) {", "while (false && tile < end) {")
    return {
        "base": (cu, cuh),
        "one_mma": (cu, edit(cuh, "  mma(t, a_lo, b_hi);\n  mma(t, a_hi, b_lo);\n", "")),
        "no_loop": (no_loop, cuh),
        "one_group": (edit(cu, "constexpr int kGroups = 2;", "constexpr int kGroups = 1;"), cuh),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_flash_bwd: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from scoreperformer_tpu_torch.ops import _build
    from scoreperformer_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    root = _build.BUILD_DIR.parent / "flash_bwd_probe"
    shutil.rmtree(root, ignore_errors=True)
    sources = variants((_build.CSRC / "flash_attention_bwd.cu").read_text(),
                       (_build.CSRC / "tf32_mma.cuh").read_text())
    builds = {}
    for name, (cu, cuh) in sources.items():
        d = root / name
        d.mkdir(parents=True)
        (d / "flash_attention_bwd.cu").write_text(cu)
        (d / "tf32_mma.cuh").write_text(cuh)
        builds[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                                         str(d / "flash_attention_bwd.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for name, proc in builds.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
    _build.build_all()  # the other kernels, for the forward that makes lse

    def use(name):
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        for symbol, argtypes in _build.ENTRY_POINTS["flash_attention_bwd"].items():
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _build._loaded[("flash_attention_bwd", symbol)] = fn

    for name in ("base", "one_group"):
        use(name)
        for b, t, causal, padded in SHAPES:
            try:
                cs.check_flash_bwd(torch, fa, b, t, causal, padded, timed=False)
            except AssertionError as exc:
                raise AssertionError(f"variant {name}: {exc}") from None
    inputs = []
    for b, t, causal, padded in SHAPES:
        q, k, v, slopes, mask, dout = cs.flash_bwd_inputs(torch, b, t, causal, padded, 4, 64, 1)
        out, lse = fa.flash_attention_fwd(q, k, v, slopes, mask, causal)
        delta = (dout * out).sum(-1)
        copies = [(q.clone(), k.clone(), v.clone(), dout.clone())
                  for _ in range(cs.n_copies(4 * (q.numel() + k.numel() + v.numel() + dout.numel())))]
        inputs.append(((b, t, causal, padded), slopes, mask, lse, delta, copies))
    names = list(sources)
    for turn, name in enumerate(names + names[::-1]):
        use(name)
        for shape, slopes, mask, lse, delta, copies in inputs:
            causal = shape[2]
            rec = {"variant": name, "turn": turn, "shape": list(shape)}
            for kernel in ("dkv", "dq"):
                fn = getattr(fa, f"flash_attention_bwd_{kernel}")
                rec[f"{kernel}_ms"] = cs.graph_ms(
                    torch, lambda qc, kc, vc, oc: fn(qc, kc, vc, slopes, mask, oc, lse, delta, causal), copies, iters=20)
            print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
