"""Time K2-bf16, K3-bf16 and K4-bf16 (``csrc/correlation_bf16.cu``)
against edited copies of their source, at the flow stage's five PWC-Net
levels, on one CUDA card: what each part of the kernels costs.

Usage, from the repository root:

    python -m xpt_mde_tpu_torch.tools.corr_variants [--variants NAME,...]

Each variant is the source with a few text edits (``VARIANTS``), built
with the package's nvcc flags into ``build/kernels/variants/`` (one nvcc
per variant, started together) and launched through its C entries with
the package's plans. Variants marked ``timing only`` drop or change work
and give other results; the others must give the built library's bits.
One line per variant: device time per launch at each level and its sum
over the levels (one flow train step's launches), in microseconds, the
mean of 20 launches replayed from one CUDA graph, tagged with the card's
name and power limit. It fails without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from xpt_mde_tpu_torch.config import NUM_SRC
from xpt_mde_tpu_torch.models.flow_net import ENCODER_CHANNELS, level_displacement
from xpt_mde_tpu_torch.ops.kernels import build
from xpt_mde_tpu_torch.ops.kernels import correlation as kcorr
from xpt_mde_tpu_torch.tools.corr_sweep import _graph_ms

PAIRS, HEIGHT, WIDTH = 8 * NUM_SRC, 128, 512
SOURCE = build.CSRC_DIR / "correlation_bf16.cu"
OUT_DIR = build.BUILD_DIR / "variants"

_LB = "__global__ void __launch_bounds__(kMaxWarps * 32, 3)\n"
_DIV = ("to_bf16(div_rn(lo.x, c, rc)), to_bf16(div_rn(lo.y, c, rc))",
        "to_bf16(div_rn(lo.z, c, rc)), to_bf16(div_rn(lo.w, c, rc))",
        "to_bf16(div_rn(hi.x, c, rc)), to_bf16(div_rn(hi.y, c, rc))",
        "to_bf16(div_rn(hi.z, c, rc)), to_bf16(div_rn(hi.w, c, rc))")
_RESULT_STORE = "  store_rows(outb + static_cast<size_t>(c_lo) * n * hw, hw, rows * n, s_part,"
_FEAT = "      const u16* s_f = s_slots + k * slot_elems;"
_SUMS_STORE = "  store_rows(out, hw, rows, s_part, part_pitch, x_hi, vec_out,"
_K3_ROW = "          mbar_expect(&bars[k], lay.row_bytes);\n"

# name -> (timing only, [(old, new), ...]); each old text must occur once
VARIANTS = {
    "as built": (False, []),
    # the division's own slow path instead of div_rn: the same bits
    "IEEE division": (False, [(d, d.replace("div_rn(", "(").replace(", c, rc)", " / c)"))
                              for d in _DIV]),
    # two blocks of 8 warps an SM (128 registers a thread) instead of three
    "two blocks an SM": (False, [(_LB + name, _LB.replace(", 3)", ", 2)") + name)
                                 for name in ("corr_fwd_bf16_kernel(",
                                              "corr_bwd_cl_bf16_kernel(",
                                              "corr_bwd_cr_bf16_kernel(")]),
    # K2 without its zero planes
    "no zero planes": (True, [("    if (i < lo_y || i > hi_y) {\n      store_rows(outb",
                               "    if (i < 0) {\n      store_rows(outb")]),
    # the three kernels without the stores of their results
    "no result stores": (True, [(_RESULT_STORE, "  if (rows < 0) " + _RESULT_STORE[2:]),
                                (_SUMS_STORE, "  if (rows < 0) " + _SUMS_STORE[2:])]),
    # the three kernels stage one displacement row's copy and read it for
    # every row
    "one staged row": (True, [
        ("        mbar_expect(&bar, lay.cl_bytes + rows * lay.row_bytes);",
         "        mbar_expect(&bar, lay.cl_bytes + lay.row_bytes);"),
        ("        for (int k = 0; k < rows; ++k) {\n          for (int q = 0; q < boxes.count;",
         "        for (int k = 0; k < 1; ++k) {\n          for (int q = 0; q < boxes.count;"),
        ("          const u16* pb = s_rows + r * row_elems + c0 * row_pitch + w0;",
         "          const u16* pb = s_rows + c0 * row_pitch + w0;"),
        ("          u16* slot = s_slots + k * slot_elems;\n          mbar_expect(&bars[k]",
         "          u16* slot = s_slots;\n          if (k > 0) {\n            mbar_expect(&bars[k], 0);"
         "\n            continue;\n          }\n          mbar_expect(&bars[k]"),
        (_FEAT, "      const u16* s_f = s_slots;"),
        (_K3_ROW, "          if (k > 0) {\n            mbar_expect(&bars[k], 0);\n"
                  "            continue;\n          }\n" + _K3_ROW),
        ("      const u16* s_cr = s_rows + k * row_elems;", "      const u16* s_cr = s_rows;")]),
}


def variant_source(name: str) -> str:
    """The source of variant ``name``: ``SOURCE`` with its edits; raises
    ValueError where an edit's old text does not occur exactly once."""
    text = SOURCE.read_text()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old[:60]!r} does not occur once in {SOURCE}")
        text = text.replace(old, new)
    return text


def _build(name: str) -> str:
    """Write and compile variant ``name``; return its library's path."""
    text = variant_source(name)
    stem = OUT_DIR / name.replace(" ", "_")
    stem.parent.mkdir(parents=True, exist_ok=True)
    src, lib = stem.with_suffix(".cu"), stem.with_suffix(".so")
    src.write_text(text)
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name!r}:\n{proc.stderr[-3000:]}")
    return str(lib)


def _entries(path: str):
    lib = ctypes.CDLL(path)
    k2, k3, k4 = lib.xpt_corr_fwd_bf16, lib.xpt_corr_bwd_cl_bf16, lib.xpt_corr_bwd_cr_bf16
    for fn, keys in ((k2, kcorr.FWD_BF16_LAUNCH_KEYS), (k3, kcorr.BWD_BF16_LAUNCH_KEYS),
                     (k4, kcorr.BWD_BF16_LAUNCH_KEYS)):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (8 + len(keys)) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return k2, k3, k4


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help="comma-separated names of VARIANTS")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("corr_variants: no CUDA device", file=sys.stderr)
        return 1
    names = args.variants.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(_build, names)))
    device = torch.device("cuda", 0)
    generator = torch.Generator().manual_seed(2)
    cases = []
    for level in (6, 5, 4, 3, 2):
        md, stride = level_displacement(level)
        shape = (PAIRS, ENCODER_CHANNELS[level - 1], HEIGHT >> level, WIDTH >> level)
        n2 = kcorr.num_displacements(md, stride) ** 2
        cl, cr = ((torch.rand(shape, generator=generator) * 2 - 1).to(device, torch.bfloat16)
                  for _ in range(2))
        g = (torch.rand((PAIRS, n2) + shape[2:], generator=generator) * 2 - 1).to(
            device, torch.bfloat16)
        cases.append((level, md, stride, cl, cr, g, kcorr.K2_BF16(cl, cr, md, stride),
                      kcorr.K3_BF16(g, cr, md, stride), kcorr.K4_BF16(g, cl, md, stride)))
    for name in names:
        k2, k3, k4 = _entries(libs[name])
        times, same = {"K2": [], "K3": [], "K4": []}, True
        for level, md, stride, cl, cr, g, ref2, ref3, ref4 in cases:
            p2 = kcorr.fwd_plan_bf16(*cl.shape, md, stride)
            p3 = kcorr.bwd_cl_plan_bf16(*cl.shape, md, stride)
            p4 = kcorr.bwd_cr_plan_bf16(*cl.shape, md, stride)
            out2, out3, out4 = (torch.empty_like(r) for r in (ref2, ref3, ref4))

            def run(fn, first, second, out, plan, keys):
                # the current stream at each launch: the graph captures on its own
                # the whole frame: cr's rows cl's, row offset 0
                err = fn(first.data_ptr(), second.data_ptr(), out.data_ptr(), *cl.shape,
                         cl.shape[2], 0, md, stride, *(plan[k] for k in keys),
                         torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"variant {name!r} launch failed with CUDA error {err}")

            launches = {"K2": lambda: run(k2, cl, cr, out2, p2, kcorr.FWD_BF16_LAUNCH_KEYS),
                        "K3": lambda: run(k3, g, cr, out3, p3, kcorr.BWD_BF16_LAUNCH_KEYS),
                        "K4": lambda: run(k4, g, cl, out4, p4, kcorr.BWD_BF16_LAUNCH_KEYS)}
            for kname, fn in launches.items():
                fn()
                times[kname].append(_graph_ms(fn))
            torch.cuda.synchronize()
            same = (same and torch.equal(out2, ref2) and torch.equal(out3, ref3)
                    and torch.equal(out4, ref4))
        timing_only = VARIANTS[name][0]
        if not (same or timing_only):
            raise AssertionError(f"variant {name!r} changed the kernels' results")
        levels = " ".join(f"L{lv} {1000 * a:.1f}/{1000 * b:.1f}/{1000 * c:.1f}"
                          for (lv, *_), a, b, c in zip(cases, times["K2"], times["K3"],
                                                       times["K4"]))
        print(f"variant {name}{' (timing only)' if timing_only else ''}: K2-bf16 "
              f"{1000 * sum(times['K2']):.1f} us, K3-bf16 {1000 * sum(times['K3']):.1f} us, "
              f"K4-bf16 {1000 * sum(times['K4']):.1f} us a flow step; us per launch "
              f"K2/K3/K4: {levels} [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
