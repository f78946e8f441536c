#!/usr/bin/env python3
"""What the fp32 flash forward's design choices cost, on one CUDA card.

    python3 chip_probe_flash_fwd.py

Run from the root of a checkout, on a machine with the CUDA toolkit. It
builds `scoreperformer_tpu_torch/csrc/flash_attention_fwd.cu` as it is
("base") and variants of it, each one edit away and each right by design but the last:
- one_group: one warpgroup (64 query rows) a CTA at d = 128 too;
- keys64: 64-key tiles at every head dim, one warpgroup a CTA (two would
  pass a block's shared memory at d = 128);
- expf: the accurate `expf` in place of `__expf`;
- no_loop: the CTA without its tile loop (q, the first tile, the split and
  the epilogue: the CTA's fixed cost); timed only, not checked.
Prints the card's name and power limit and each variant's registers,
spills and C7518 messages, checks that each variant's SASS holds TF32
warpgroup MMAs (HGMMA) and no TF32 HMMA at every head dim, holds every
variant to the plain version at edge and path shapes
(`chip_smoke.check_flash`: o and lse within 1e-4 of the fp64 plain version,
the same bits twice; exit 1 on a failure), then times the variants at the
paths' fp32 shapes by CUDA-graph replay, in turns (each variant, then back
in reverse order), after one timed `check_flash` of the base at each shape
(SDPA with the bias beside, and the tensor-core bound). One JSON line per
record.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

# (b, h, KV heads, d, t, causal, padded, what): the paths' fp32 shapes
SHAPES = [
    (1, 4, 1, 64, 344, False, False, "render"),
    (1, 4, 1, 64, 249, False, False, "stream encoder chunk"),
    (4, 4, 1, 64, 64, False, True, "mlm_unmask"),
    (128, 4, 1, 64, 258, False, True, "flagship encoders"),
    (128, 4, 1, 64, 257, True, True, "flagship decoder"),
    (128, 4, 1, 64, 384, False, True, "served encoders"),
    (8, 8, 1, 128, 1025, True, True, "scale_1024 decoder, 1024 notes"),
    (8, 8, 1, 128, 1026, False, True, "d = 128, 1024 notes"),
    (8, 8, 1, 128, 2049, True, True, "scale_1024 decoder, 2048 notes"),
    (8, 8, 1, 128, 2050, False, True, "d = 128, 2048 notes"),
    (8, 8, 8, 64, 1026, False, True, "scale_1024 encoders"),
    (4, 2, 1, 16, 49, True, True, "smoke decoder"),
    (4, 2, 1, 16, 50, False, True, "smoke encoders"),
]
TIMED_ONLY = ("no_loop",)  # variants that are not right by design
GROUPS_RULE = "  const int groups = D == 128 && (row_blocks + 1) / 2 * slabs >= sms ? 2 : 1;\n"
KEYS_RULE = "  static constexpr int kKeys = D == 16 ? 64 : 32;\n"


def variants(cu):
    """name -> kernel source."""
    def edit(text, old, new):
        if text.count(old) != 1:
            raise AssertionError(f"variant edit does not apply: {old!r}")
        return text.replace(old, new)

    one_group = edit(cu, GROUPS_RULE, "  const int groups = 1;\n")
    return {
        "base": cu,
        "one_group": one_group,
        "keys64": edit(one_group, KEYS_RULE, "  static constexpr int kKeys = 64;\n"),
        "no_loop": edit(cu, "for (int j = 0; tile < end; ++j) {", "for (int j = 0; false && tile < end; ++j) {"),
        "expf": cu.replace("__expf(", "expf("),
    }


def checks(cs):
    """chip_smoke.check_flash's keyword arguments of each edge and path case."""
    cases = [dict(b=2, t=t, causal=c, padded=False) for t in (1, 15, 17, 63, 65, 129) for c in (False, True)]
    cases += [dict(b=2, t=t, causal=c, padded=False, h=8, d=128) for t in (1, 17, 33, 65, 129) for c in (False, True)]
    cases += [dict(b=2, t=t, causal=c, padded=False, h=2, d=16) for t in (1, 15, 49, 129) for c in (False, True)]
    cases += [
        dict(b=2, t=77, causal=True, padded=True, d=32), dict(b=3, t=77, causal=True, padded="empty", d=32),
        dict(b=2, t=37, causal=False, padded="empty"), dict(b=2, t=300, causal=True, padded="empty"),
        dict(b=4, t=130, causal=False, padded=True, hk=4), dict(b=2, t=300, causal=True, padded="empty", hk=4),
        dict(b=3, t=200, causal=True, padded="late", lengths=[(70, 200), (5, 90), (130, 131)]),
        dict(b=3, t=200, causal=True, padded="late", lengths=[(70, 200), (5, 90), (130, 131)], h=8, d=128),
        dict(b=128, t=384, causal=False, padded="warmup", lengths=[1] * 128),
        dict(b=2, t=130, causal=False, padded=True, h=8, d=128, hk=8),
        dict(b=3, t=77, causal=True, padded="empty", h=2, d=16),
    ]
    cases += [dict(b=4, t=384, causal=c, padded="tails", lengths=[0, 3, 64, 130], **hd)
              for c in (False, True) for hd in ({}, dict(h=8, d=128), dict(h=2, d=16))]
    cases += [dict(b=b, t=t, causal=c, padded=True, h=h, d=d, hk=hk)
              for b, h, hk, d, t, c, _, _ in SHAPES if t <= 1026]
    return cases


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_flash_fwd: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from scoreperformer_tpu_torch.ops import _build
    from scoreperformer_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    root = _build.BUILD_DIR.parent / "flash_fwd_probe"
    shutil.rmtree(root, ignore_errors=True)
    sources = variants((_build.CSRC / "flash_attention_fwd.cu").read_text())
    builds = {}
    for name, cu in sources.items():
        d = root / name
        d.mkdir(parents=True)
        (d / "flash_attention_fwd.cu").write_text(cu)
        builds[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                                         str(d / "lib.so"), str(d / "flash_attention_fwd.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for name, proc in builds.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lines = log.splitlines()
        print(json.dumps({"variant": name, "C7518": [line.strip() for line in lines if "C7518" in line],
                          "entries": [line.split("Compiling entry function '")[1].split("'")[0] for line in lines
                                      if "Compiling entry function" in line],
                          "registers": [line.split("Used ")[1].split(" registers")[0] for line in lines
                                        if "registers" in line],
                          "spills": [line.strip() for line in lines
                                     if "spill stores" in line and " 0 bytes spill" not in line]}), flush=True)
        if name in TIMED_ONLY:
            continue
        counts, dims = cs.tensor_core_counts(root / name / "lib.so", ("flash_fwd",), fa.KERNEL_HEAD_DIMS,
                                             instruction=cs.TF32_HGMMA, forbidden=cs.TF32_HMMA)
        print(json.dumps({"variant": name, "tf32_hgmma": counts, "tf32_hgmma_by_head_dim": dims}), flush=True)

    symbol = "sp_flash_attention_fwd"

    def use(name):
        fn = getattr(ctypes.CDLL(str(root / name / "lib.so")), symbol)
        fn.argtypes, fn.restype = _build.ENTRY_POINTS["flash_attention_fwd"][symbol], ctypes.c_int
        _build._loaded[("flash_attention_fwd", symbol)] = fn

    for name in sources:
        if name in TIMED_ONLY:
            continue
        use(name)
        worst = 0.0
        for case in checks(cs):
            try:
                rec = cs.check_flash(torch, fa, timed=False, **case)
            except AssertionError as exc:
                raise AssertionError(f"variant {name}: {exc}") from None
            worst = max(worst, rec["max_abs_err"])
        print(json.dumps({"variant": name, "checks": len(checks(cs)), "passed": True, "max_abs_err": worst}),
              flush=True)

    use("base")
    inputs = []
    for b, h, hk, d, t, causal, padded, what in SHAPES:
        rec = cs.check_flash(torch, fa, b, t, causal=causal, padded=padded, timed=True, h=h, d=d, hk=hk)
        rec["over_library"] = rec["ms"] / rec["library_ms"]
        rec["over_bound_tc"] = rec["ms"] / rec["bound_tc_ms"]
        print(json.dumps({"variant": "base", "path": what, **rec}), flush=True)
        q, k, v, slopes, mask, _ = cs.flash_bwd_inputs(torch, b, t, causal, padded, h, d, hk)
        copies = [(q.clone(), k.clone(), v.clone()) for _ in range(cs.n_copies(4 * (q.numel() + k.numel() + v.numel())))]
        inputs.append(([b, h, hk, d, t, causal], slopes, mask, copies))
    names = list(sources)
    for turn, name in enumerate(names + names[::-1]):
        use(name)
        for shape, slopes, mask, copies in inputs:
            causal = shape[-1]
            ms = cs.graph_ms(torch, lambda qc, kc, vc: fa.flash_attention_fwd(qc, kc, vc, slopes, mask, causal),
                             copies, iters=50)
            print(json.dumps({"variant": name, "turn": turn, "shape": shape, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
