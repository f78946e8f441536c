#!/usr/bin/env python3
"""What the bf16 flash forward's design choices cost, on one CUDA card.

    python3 chip_probe_flash_fwd_bf16.py

Run from the root of a checkout, on a machine with the CUDA toolkit. It
builds `scoreperformer_tpu_torch/csrc/flash_attention_fwd_bf16.cu` as it is
("base") and three variants of it, each one edit away and each right by
design, holds every one to the plain version (`chip_smoke.check_flash_bf16`)
and times them at the paths' bf16 shapes by CUDA-graph replay, in turns
(base, expf, cond_wait, turns, then back in reverse order):
- expf: the accurate `expf` in place of `__expf`;
- cond_wait: S waited for only on the iterations that issue it, which
  makes ptxas serialize every wgmma (its C7518 message);
- turns: the two warpgroups take turns to issue a tile's P.V on two named
  barriers, so that one's softmax runs while the other's products do.
Prints the card's name and power limit, each variant's registers, spills
and C7518 messages, then one JSON line per variant, shape and turn.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

# (b, h, KV heads, d, t, causal): the flagship's encoders and decoder, then
# chip_smoke.FLASH_TIMED_SHAPES up to 1026 notes
SHAPES = [(128, 4, 1, 64, 258, False), (128, 4, 1, 64, 257, True), (8, 8, 1, 128, 1025, True),
          (8, 8, 1, 128, 1026, False), (8, 8, 8, 64, 1026, False), (4, 2, 1, 16, 49, True), (4, 2, 1, 16, 50, False)]


def variants(cu):
    """name -> kernel source."""
    def edit(text, old, new):
        if text.count(old) != 1:
            raise AssertionError(f"variant edit does not apply: {old!r}")
        return text.replace(old, new)

    turns = edit(cu, "  float s[32];\n", """  auto take_turn = [&] { asm volatile("bar.sync %0, %1;\\n" ::"r"(1 + group), "n"(kGroups * kWG) : "memory"); };
  auto give_turn = [&] { asm volatile("bar.arrive %0, %1;\\n" ::"r"(2 - group), "n"(kGroups * kWG) : "memory"); };
  if (group == 1) give_turn();
  float s[32];
""")
    turns = edit(turns, "    float tile_sum[D / 2];\n    wg::hold(a);", "    float tile_sum[D / 2];\n    take_turn();\n    wg::hold(a);")
    turns = edit(turns, "    wg::commit();\n    refill(j);", "    wg::commit();\n    if (group == 0 || !last) give_turn();\n    refill(j);")
    return {
        "base": cu,
        "expf": cu.replace("__expf(", "expf("),
        "cond_wait": edit(cu, "    wg::wait_all();\n    wg::hold(s);\n    tile = nxt;",
                          "    if (!last) {\n      wg::wait_all();\n      wg::hold(s);\n    }\n    tile = nxt;"),
        "turns": turns,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_flash_fwd_bf16: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from scoreperformer_tpu_torch.ops import _build
    from scoreperformer_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    root = _build.BUILD_DIR.parent / "flash_fwd_bf16_probe"
    shutil.rmtree(root, ignore_errors=True)
    sources = variants((_build.CSRC / "flash_attention_fwd_bf16.cu").read_text())
    builds = {}
    for name, cu in sources.items():
        d = root / name
        d.mkdir(parents=True)
        (d / "flash_attention_fwd_bf16.cu").write_text(cu)
        builds[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                                         str(d / "lib.so"), str(d / "flash_attention_fwd_bf16.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for name, proc in builds.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lines = log.splitlines()
        print(json.dumps({"variant": name, "C7518": sum("C7518" in line for line in lines),
                          "registers": [line.split("Used ")[1].split(" registers")[0] for line in lines
                                        if "registers" in line],
                          "spills": [line.strip() for line in lines if "spill stores" in line and " 0 bytes spill" not in line]}))
    _build.build_all()  # the backward kernels, which check_flash_bf16 also holds

    symbol = "sp_flash_attention_fwd_bf16"

    def use(name):
        fn = getattr(ctypes.CDLL(str(root / name / "lib.so")), symbol)
        fn.argtypes, fn.restype = _build.ENTRY_POINTS["flash_attention_fwd_bf16"][symbol], ctypes.c_int
        _build._loaded[("flash_attention_fwd_bf16", symbol)] = fn

    for name in sources:
        use(name)
        for case in (dict(b=2, t=129, causal=True, padded=False, h=8, d=128),
                     dict(b=3, t=77, causal=True, padded="empty", d=32),
                     dict(b=128, t=258, causal=False, padded=True)):
            try:
                cs.check_flash_bf16(torch, fa, timed=False, **case)
            except AssertionError as exc:
                raise AssertionError(f"variant {name}: {exc}") from None
    inputs = []
    for b, h, hk, d, t, causal in SHAPES:
        q, k, v, slopes, mask, _ = cs.flash_bwd_inputs(torch, b, t, causal, True, h, d, hk)
        q, k, v = (x.bfloat16() for x in (q, k, v))
        copies = [(q.clone(), k.clone(), v.clone()) for _ in range(cs.n_copies(2 * (q.numel() + k.numel() + v.numel())))]
        inputs.append(([b, h, hk, d, t, causal], slopes, mask, copies))
    names = list(sources)
    for turn, name in enumerate(names + names[::-1]):
        use(name)
        for shape, slopes, mask, copies in inputs:
            causal = shape[-1]
            ms = cs.graph_ms(torch, lambda qc, kc, vc: fa.flash_attention_fwd(qc, kc, vc, slopes, mask, causal),
                             copies, iters=50)
            print(json.dumps({"variant": name, "turn": turn, "shape": shape, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
