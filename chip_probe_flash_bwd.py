#!/usr/bin/env python3
"""Where the fp32 flash backward kernels' time goes, on one CUDA card.

    python3 chip_probe_flash_bwd.py

Run from the root of a checkout, on a machine with the CUDA toolkit. It
builds `scoreperformer_tpu_torch/csrc/flash_attention_bwd.cu` (split-TF32
`wgmma`) as it is ("base") and three variants of it, each one edit away,
prints what ptxas reports of each (registers, spills, serialized wgmma:
C7518), holds base and no_cluster to the plain versions at the edge cases
and the paths' shapes (every case is run and its verdict printed; any
failure ends the run with exit code 1), then times both kernels of each
variant by CUDA-graph replay, in turns (base, one_mma, no_loop,
no_cluster, then back in reverse order), at the training paths' shapes:
- one_mma: one TF32 product a product in place of the split's three
  (wrong by design): the share of the time that the split's products take;
- no_loop: the tile loops removed (wrong by design): what the set-up and
  the write-back alone take;
- no_cluster: dK/dV without the cluster split of the query heads (right):
  what the split buys at small grids.
Prints the card's name and power limit, then one JSON line per check and
per variant, shape and turn.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

# (b, t, causal, padded, h, d, hk, lengths): t from 1 up around the tiles,
# every head dim, MHA, rows with no valid key, late keys, long padded tails
CHECKS = [
    (2, 1, True, False, 2, 16, 1, None), (2, 77, True, True, 4, 64, 1, None), (2, 77, False, True, 4, 16, 1, None),
    (2, 77, False, True, 4, 32, 1, None), (2, 77, True, True, 4, 128, 1, None), (2, 129, True, False, 2, 128, 1, None),
    (2, 130, False, "empty", 4, 64, 4, None), (2, 77, True, "empty", 2, 128, 2, None),
    (3, 200, True, "late", 4, 64, 1, [(70, 200), (5, 90), (130, 131)]),
    (4, 384, False, "tails", 4, 64, 1, [0, 3, 64, 130]), (4, 384, True, "tails", 2, 16, 1, [0, 3, 64, 130]),
    (4, 49, True, True, 2, 16, 1, None), (4, 50, False, True, 2, 16, 1, None),
    (16, 257, True, True, 2, 64, 1, None), (16, 257, True, True, 4, 64, 1, None),
    (128, 258, False, True, 4, 64, 1, None), (128, 257, True, True, 4, 64, 1, None),
    (8, 1026, False, True, 8, 128, 1, None), (8, 1026, False, True, 8, 64, 8, None),
]
# (b, t, causal, h, d, hk): the flagship's encoders and decoder, a pipeline
# microbatch on a model axis of 2 and at 4 heads, scale_1024's decoder and
# encoders, the smoke shape's decoder and encoders (all padded)
SHAPES = [(128, 258, False, 4, 64, 1), (128, 257, True, 4, 64, 1), (16, 257, True, 2, 64, 1),
          (16, 257, True, 4, 64, 1), (8, 1026, False, 8, 128, 1), (8, 1025, True, 8, 128, 1),
          (8, 1026, False, 8, 64, 8), (4, 49, True, 2, 16, 1), (4, 50, False, 2, 16, 1)]


def edit(text, old, new):
    if old not in text:
        raise AssertionError(f"variant edit does not apply: {old!r}")
    return text.replace(old, new)


def variants(cu):
    """name -> kernel source."""
    one_mma = edit(edit(cu, """  wg::tf32_ss<N>(d, A::desc_k(a + A::kBytes, ks), B::desc_k(b, ks), 0);  // lo.hi
  wg::tf32_ss<N>(d, A::desc_k(a, ks), B::desc_k(b + B::kBytes, ks), 1);  // hi.lo
  wg::tf32_ss<N>(d, A::desc_k(a, ks), B::desc_k(b, ks), 1);              // hi.hi""",
                        "  wg::tf32_ss<N>(d, A::desc_k(a, ks), B::desc_k(b, ks), 0);"),
                   """  wg::tf32_rs<N>(d, a[1], B::desc_k(b, kk), !first);         // lo.hi
  wg::tf32_rs<N>(d, a[0], B::desc_k(b + B::kBytes, kk), 1);  // hi.lo
  wg::tf32_rs<N>(d, a[0], B::desc_k(b, kk), 1);              // hi.hi""",
                   "  wg::tf32_rs<N>(d, a[0], B::desc_k(b, kk), !first);")
    no_loop = edit(edit(cu, "for (int j = 0; item.head < n_heads; ++j) {",
                        "for (int j = 0; false && item.head < n_heads; ++j) {"),
                   "for (int j = 0; tile < end; ++j) {", "for (int j = 0; false && tile < end; ++j) {")
    return {
        "base": cu,
        "one_mma": one_mma,
        "no_loop": no_loop,
        "no_cluster": edit(cu, "while (hk == 1 && split < 8", "while (false && hk == 1 && split < 8"),
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
    sources = variants((_build.CSRC / "flash_attention_bwd.cu").read_text())
    builds = {}
    for name, cu in sources.items():
        d = root / name
        d.mkdir(parents=True)
        (d / "flash_attention_bwd.cu").write_text(cu)
        builds[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                                         "-o", str(d / "lib.so"), str(d / "flash_attention_bwd.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for name, proc in builds.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "C7518" in line or "Compiling entry" in line:
                print(f"ptxas {name}: {line.strip()}")
    _build.build_all()  # the other kernels, for the forward that makes lse

    def use(name):
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        for symbol, argtypes in _build.ENTRY_POINTS["flash_attention_bwd"].items():
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _build._loaded[("flash_attention_bwd", symbol)] = fn

    failed = 0
    for name in ("base", "no_cluster"):
        use(name)
        for b, t, causal, padded, h, d, hk, lengths in CHECKS:
            case = {"variant": name, "case": [b, t, causal, padded, h, d, hk]}
            try:
                dkv, dq, _ = cs.check_flash_bwd(torch, fa, b, t, causal, padded, timed=False, h=h, d=d, hk=hk,
                                                lengths=lengths)
                print(json.dumps({**case, "ok": True, "errors": dkv["errors"]}))
            except (AssertionError, RuntimeError) as exc:
                failed += 1
                print(json.dumps({**case, "ok": False, "error": str(exc)}))
            torch.cuda.synchronize()
    if failed:
        return 1
    inputs = []
    for b, t, causal, h, d, hk in SHAPES:
        q, k, v, slopes, mask, dout = cs.flash_bwd_inputs(torch, b, t, causal, True, h, d, hk)
        out, lse = fa.flash_attention_fwd(q, k, v, slopes, mask, causal)
        delta = (dout * out).sum(-1)
        copies = [(q.clone(), k.clone(), v.clone(), dout.clone())
                  for _ in range(cs.n_copies(4 * (q.numel() + k.numel() + v.numel() + dout.numel())))]
        inputs.append(((b, t, causal, h, d, hk), slopes, mask, lse, delta, copies))
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
