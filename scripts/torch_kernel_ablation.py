"""Where a kernel's time goes: K1/K1b, K3 and K4 with one phase removed at a time.

    python3 scripts/torch_kernel_ablation.py

Run from the root of a checkout on a machine with a Hopper card and nvcc.
Builds variants of ``csrc/flash_attention_packed.cu``, ``csrc/fused_log_mel.cu``
and ``csrc/fused_resnet_causal.cu`` into ``build/ablation/``, each with one
phase cut out of the source text (the outputs of a cut variant are wrong;
only its time means something), and prints each variant's time (CUDA events,
mean of 20 back-to-back launches, two rounds in turn) at the main path's
shapes: the bf16 flash attention at B=16 T=499 H=12 with chip_smoke.py's
ragged n_valid, without (K1) and with (K1b) WavLM's bias; K3 at Whisper's
B=16 (``log10_clamp``, strided view); K4's float32 (3xTF32) and bf16 forms at
the four encodec-emb call sites of a B=16 x 10 s forward. The full kernel
minus a variant is what the removed phase costs, as far as the phases do not
overlap.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from fadtk_tpu_torch.dsp import mel as dmel  # noqa: E402
from fadtk_tpu_torch.ops import build  # noqa: E402
from fadtk_tpu_torch.ops import flash_attention as fa  # noqa: E402
from fadtk_tpu_torch.ops import fused_log_mel as k3  # noqa: E402
from fadtk_tpu_torch.ops import fused_resnet as fr  # noqa: E402

OUT = build.REPO / "build" / "ablation"

K3_NEXT = ("      if (next) {\n        stage_bases(s + 1, c, (s + 1) & 1);\n        load(s + 1);\n"
           "      }\n")
K3_VARIANTS = {
    "full": [],
    "no mel product": [("        if (lo >= hi) continue;", "        continue;")],
    "no next-slice staging and fold": [(K3_NEXT, ""),
                                       ("      if (next) fold_store((s + 1) & 1);\n", "")],
}
ATTN_PV = ("        mma_bf16(o[j], pa[kk], vb[0], vb[1]);\n"
           "        mma_bf16(o[j + 1], pa[kk], vb[2], vb[3]);\n")
ATTN_EXP = ("      const float p0 = exp2f((s[j][0] - mn0) * LOG2E), p1 = exp2f((s[j][1] - mn0) * LOG2E);\n"
            "      const float p2 = exp2f((s[j][2] - mn1) * LOG2E), p3 = exp2f((s[j][3] - mn1) * LOG2E);\n")
ATTN_VARIANTS = {
    "full": [],
    "no p.v product": [(ATTN_PV, "", None)],
    "no softmax exponentials": [(ATTN_EXP, "      const float p0 = s[j][0], p1 = s[j][1], p2 = s[j][2], "
                                           "p3 = s[j][3];\n", None)],
    "no K/V ring overlap": [("    cp_async_wait<1>();", "    cp_async_wait<0>();", None)],
}
K4_ITEMS = "for (int it = warp; it < ITEMS; it += S::WARPS) {"
# The f32 form's two item loops come first in the source, then the bf16 form's.
K4F32_LO = [("mma_tf32(acc[mi][ni], alo[mi], bh[ni][0], bh[ni][1]);", ";", None),
            ("mma_tf32(acc[mi][ni], ahi[mi], bl[ni][0], bl[ni][1]);", ";", None)]
K4F32_SPLIT = ("          ahi[mi][e] = tf32_rna(va[mi][e]);\n"
               "          alo[mi][e] = tf32_rna(va[mi][e] - __uint_as_float(ahi[mi][e]));\n")
K4F32_ELU = "  if (v <= -0.0625f) return __expf(v) - 1.f;"
K4F32_SMEM = "  static constexpr int ELEMS = (4 * C + CH) * LD;"
K4F32_VARIANTS = {
    "full": [],
    "no lo terms (1xTF32)": K4F32_LO,
    "no on-chip split of x and h": [(K4F32_SPLIT, "          ahi[mi][e] = __float_as_uint(va[mi][e]);\n"
                                                  "          alo[mi][e] = 0u;\n", None)],
    "elu by expm1f": [(K4F32_ELU, "  return expm1f(v);", None)],
    "no elu": [("float elu(float v) {\n  if (v > 0.f) return v;", "float elu(float v) {\n  return v;",
                None)],
    "no h product": [(K4_ITEMS, K4_ITEMS.replace("it < ITEMS", "it < 0"), 0)],
    "no weight loads": [("    for (int ni = 0; ni < NT; ++ni) vb[ni] = __ldg(pw + ((size_t)ni * KT + kt) * 32);",
                         "    for (int ni = 0; ni < NT; ++ni) vb[ni] = make_float4(kt, 1.f, 0.f, 0.f);",
                         None)],
    "no elu staging": [("#pragma unroll 2\n      for (int i = tid; i < N; i += NTH) {",
                        "#pragma unroll 2\n      for (int i = tid; i < 0 * N; i += NTH) {", None)],
    "no store": [("    for (int i = tid; i < C * (TT / 4); i += NTH) {",
                  "    for (int i = tid; i < 0 * C * (TT / 4); i += NTH) {", None)],
    "no products": [(K4_ITEMS, K4_ITEMS.replace("it < ITEMS", "it < 0"), 0),
                    (K4_ITEMS, K4_ITEMS.replace("it < ITEMS", "it < 0"), 0)],
    "3 CTAs per SM at C <= 128": [(K4F32_SMEM, K4F32_SMEM.replace(
        "* LD;", "* LD + (C <= 128 ? 4096 : 0);"), None)],
}
K4_ETRANSPOSE = "      for (int i = tid; i < (C / 2) * (TT / 8); i += NTH) {"
K4_STORE = "    for (int i = tid; i < C * (TT / 8); i += NTH) {"
K4_VARIANTS = {
    "full": [],
    "no h product": [(K4_ITEMS, K4_ITEMS.replace("it < ITEMS", "it < 0"), 2)],
    "no products": [(K4_ITEMS, K4_ITEMS.replace("it < ITEMS", "it < 0"), None)],
    "no elu transpose": [(K4_ETRANSPOSE, K4_ETRANSPOSE.replace("i < (C / 2)", "i < 0 * (C / 2)"),
                          None)],
    "no store": [(K4_STORE, K4_STORE.replace("i < C *", "i < 0 *"), None)],
}


def _edit(src: str, old: str, new: str, nth=None) -> str:
    if old not in src:
        raise SystemExit(f"ablation: the source no longer has {old.strip()[:60]!r}")
    if nth is None:
        return src.replace(old, new)
    at = -1
    for _ in range(nth + 1):
        at = src.index(old, at + 1)
    return src[:at] + new + src[at + len(old):]


def build_variants(source: Path, variants: dict, tag: str = "") -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = source.read_text()
        for edit in edits:
            text = _edit(text, *edit)
        slug = "".join(ch if ch.isalnum() else "_" for ch in f"{tag}{name}")
        cu = OUT / f"{source.stem}-{slug}.cu"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o",
                                         str(cu.with_suffix(".so")), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), cu.with_suffix(".so"))
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{source.name} {name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def ms(fn, runs: int = 20) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def k3_calls(libs) -> dict:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    frames = dmel.whisper_frames(torch.randn((16, dmel.WHISPER_SAMPLES), generator=g,
                                             device=dev) * 0.1)
    bases = dmel._device_bases("whisper", dev)
    layout = k3.kernel_layout(*bases)
    out = torch.empty((16, 3000, 80), device=dev)
    calls = {}
    for name, lib in libs.items():
        fn = lib.fadtk_fused_log_mel
        fn.restype = ctypes.c_int
        fn.argtypes = k3._library().fadtk_fused_log_mel.argtypes

        def call(fn=fn):
            rc = fn(frames.data_ptr(), frames.stride(0), frames.stride(1), 16, 3000, 400,
                    int(layout.fold), layout.bases.data_ptr(), layout.bases.shape[1],
                    layout.bases.shape[2], 201, bases[2].data_ptr(), layout.band.data_ptr(), 80,
                    out.data_ptr(), 1, 0.0, torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc
        calls[name] = call
    return calls


def attn_calls(libs) -> dict:
    dev = torch.device("cuda")
    b, t, h = 16, 499, 12
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((b, t, h * 64), generator=g, device=dev).bfloat16() for _ in range(3))
    nv = torch.tensor([1, 64, 65, t, t - 1, 128, 2, 200, 63, t, 129, 300, t // 2, 450, 191, t],
                      dtype=torch.int32, device=dev)
    pb = torch.randn((h, t, t), generator=g, device=dev)
    gate = torch.rand((b, t, h), generator=g, device=dev) * 2 + 1
    out = torch.empty_like(q)
    calls = {}
    for name, lib in libs.items():
        fn = lib.fadtk_flash_attention_packed
        fn.restype = ctypes.c_int
        fn.argtypes = fa._library().fadtk_flash_attention_packed.argtypes
        for label, bias in (("K1", (None, None)), ("K1b", (pb.data_ptr(), gate.data_ptr()))):
            def call(fn=fn, bias=bias):
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), nv.data_ptr(), *bias,
                        out.data_ptr(), b, t, h, 1, torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc
            calls[f"{label} {name}"] = call
    return calls


def k4_calls(libs, dtype) -> dict:
    dev = torch.device("cuda")
    sites = []
    for c, t in ((32, 240000), (64, 120000), (128, 30000), (256, 6000)):
        g = torch.Generator(device=dev).manual_seed(c)
        x = (torch.randn((16, c, t), generator=g, device=dev) * 0.5).to(dtype)
        w = [((torch.rand(s, generator=g, device=dev) * 2 - 1) * 0.2).to(dtype)
             for s in ((c // 2, c, 3), (c // 2,), (c, c // 2), (c,), (c, c), (c,))]
        sites.append((c, t, x, fr.kernel_weights(*w), torch.empty_like(x)))
    entry = "fadtk_fused_resnet_causal_bf16" if dtype == torch.bfloat16 else \
        "fadtk_fused_resnet_causal"
    calls = {}
    for name, lib in libs.items():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        for c, t, x, layout, out in sites:
            def call(fn=fn, c=c, t=t, x=x, layout=layout, out=out):
                rc = fn(x.data_ptr(), *(v.data_ptr() for v in layout), out.data_ptr(), 16, c, t,
                        torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc
            calls[f"{name} C={c}"] = call
    return calls


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    resnet = build.CSRC / "fused_resnet_causal.cu"
    calls = {**attn_calls(build_variants(build.CSRC / "flash_attention_packed.cu",
                                         ATTN_VARIANTS)),
             **{f"K3 {k}": v for k, v in k3_calls(build_variants(
                 build.CSRC / "fused_log_mel.cu", K3_VARIANTS)).items()},
             **{f"K4 f32 {k}": v for k, v in k4_calls(build_variants(
                 resnet, K4F32_VARIANTS, "f32"), torch.float32).items()},
             **{f"K4 bf16 {k}": v for k, v in k4_calls(build_variants(
                 resnet, K4_VARIANTS), torch.bfloat16).items()}}
    times = {k: [] for k in calls}
    for _ in range(2):
        for name, call in calls.items():
            times[name].append(ms(call))
    for name, t in times.items():
        print(f"{name}: {' / '.join(f'{v:.4f}' for v in t)} ms", flush=True)


if __name__ == "__main__":
    main()
