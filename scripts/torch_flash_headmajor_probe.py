"""Build-and-check probe of the port's flash-attention kernel in its
head-major forms (K2: no bias, WavLM's factorized bias, the grouped grid, and
head-split strided views), beside the packed forms (K1, K1b), on one CUDA
card.

    python3 scripts/torch_flash_headmajor_probe.py

Run from the root of a checkout on a machine with a Hopper card and nvcc.
Builds the kernel, prints the ptxas report (registers, shared memory,
spills) and the grouped form's G, and for bf16 and f32 at B=16 T=499 H=12
and a small ragged case prints, per form, the max abs error against the
plain twin on valid rows, finiteness, whether fully padded 64-row tiles are
zero, and the mean CUDA-event time of 20 launches; SDPA on the head-major
tensors with a boolean key mask is timed beside them. chip_smoke.py is the full
check; this is the short first call for a kernel edit.
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from fadtk_tpu_torch.ops import flash_attention as fa  # noqa: E402


def check(label, run, ref, nv, t, head_axis):
    out = run()
    want = ref()
    torch.cuda.synchronize()
    err, zero = 0.0, True
    for b, n in enumerate(nv.tolist()):
        o, w = (x[b].float() for x in (out, want))
        if head_axis:  # (H, T, D) per batch element
            o, w = o.transpose(0, 1), w.transpose(0, 1)
        err = max(err, (o[:n] - w[:n]).abs().max().item())
        dead = -(-n // 64) * 64
        if dead < t:
            zero &= o[dead:].abs().max().item() == 0
    for _ in range(3):
        run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        run()
    end.record()
    end.synchronize()
    print(label, "err", err, "finite", bool(torch.isfinite(out.float()).all()), "zeros", zero,
          "ms", start.elapsed_time(end) / 20, flush=True)


def main() -> None:
    t0 = time.time()
    lib = fa.library_path()
    print(f"build {time.time() - t0:.1f} s")
    print(lib.with_suffix(".log").read_text())
    dev = "cuda"
    for dtype in (torch.bfloat16, torch.float32):
        for b_, t, h in ((16, 499, 12), (3, 130, 2)):
            code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
            print(dtype, b_, t, h, "G =", fa._library().fadtk_flash_attention_pick_group(
                b_, t, h, code), flush=True)
            g = torch.Generator(device=dev).manual_seed(t)
            packed = [torch.randn((b_, t, h * 64), generator=g, device=dev).to(dtype)
                      for _ in range(3)]
            pb = torch.randn((h, t, t), generator=g, device=dev)
            gate = torch.rand((b_, t, h), generator=g, device=dev) * 2 + 1
            nv_list = [1, 64, 65, t, t - 1, 128, 2, 200, 63, t, 129, 300, t // 2, 450, 191, t]
            nv = torch.tensor([min(n, t) for n in nv_list[:b_]], dtype=torch.int32, device=dev)
            views = [x.view(b_, t, h, 64).transpose(1, 2) for x in packed]
            heads = [x.contiguous() for x in views]
            gate_h = gate.transpose(1, 2).contiguous()
            for bias in (False, True):
                extra = (pb, gate) if bias else (None, None)
                check(f"{dtype} {b_} {t} {h} K1{'b' if bias else ''}",
                      lambda: fa.flash_attention_packed(*packed, nv, *extra, num_heads=h),
                      lambda: fa.flash_attention_packed_reference(*packed, nv, *extra,
                                                                  num_heads=h), nv, t, False)
                extra = (pb, gate_h) if bias else (None, None)
                for name, qkv in (("contiguous", heads), ("strided", views)):
                    check(f"{dtype} {b_} {t} {h} K2 {'bias' if bias else 'plain'} {name}",
                          lambda: fa.flash_attention(*qkv, nv, *extra),
                          lambda: fa.flash_attention_reference(*qkv, nv, *extra), nv, t, True)
            check(f"{dtype} {b_} {t} {h} K2 grouped",
                  lambda: fa.flash_attention(*heads, nv, grouped=True),
                  lambda: fa.flash_attention_reference(*heads, nv), nv, t, True)
            key_live = (torch.arange(t, device=dev)[None, :] < nv[:, None].long())[:, None, None]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            check(f"{dtype} {b_} {t} {h} SDPA (bool key mask; vs the no-bias twin)",
                  lambda: sdpa(*heads, attn_mask=key_live),
                  lambda: fa.flash_attention_reference(*heads, nv), nv, t, True)
    print("launches", fa.flash_attention.launches, fa.flash_attention.bias_launches,
          fa.flash_attention.grouped_launches)


if __name__ == "__main__":
    main()
