"""What the f32 attention backward's tensor-core route can reach on the card.

Two readings behind ``csrc/attention_tf32.cuh``'s note and PERF.md:

* ``mma.sync.m16n8k8`` TF32 on its own: a kernel of independent products
  (``chains`` accumulators a warp, ``warps`` warps a CTA, one or two CTAs
  an SM), its TFLOP/s and the cycles a product takes on each of an SM's
  four schedulers; with one chain and one warp a scheduler that is the
  product's latency, with many the issue interval the kernels can reach.
* The instruction census of the f32 backward kernels' loops (``cuobjdump
  -sass`` of the built library): for each loop that issues tensor-core
  products, its instructions and its products, so the instructions that
  issue beside each product.

    python -m kokoro_tpu_torch.scripts.probe_tf32 [--out FILE]

Needs the card and ``nvcc`` (built under ``kokoro_tpu_torch/build/``);
prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

PROBE = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
               "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int CHAINS>
__global__ void probe(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  float d[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) mma(d[c], a, a[0] + c, a[1]);
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int CHAINS>
void run(int warps, int ctas_per_sm) {
  int sms = 0, khz = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float) * sms * ctas_per_sm * 32 * warps);
  const int iters = 4096;
  probe<CHAINS><<<sms * ctas_per_sm, 32 * warps>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  probe<CHAINS><<<sms * ctas_per_sm, 32 * warps>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double mmas = (double)sms * ctas_per_sm * warps * iters * CHAINS;
  printf("%d %d %d %.6f %.3f %.3f %.0f\n", CHAINS, warps, ctas_per_sm, ms,
         mmas * 2048.0 / (ms * 1e-3) / 1e12, ms * 1e-3 * khz * 1e3 / (mmas / sms / 4), khz / 1e3);
  cudaFree(out);
}
int main() {
  run<1>(4, 1);
  run<4>(4, 1);
  run<8>(8, 2);
  run<16>(8, 2);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


def mma_probe(build_dir: Path) -> list:
    """One row a configuration: chains a warp, warps a CTA, CTAs an SM, ms,
    TF32 TFLOP/s, cycles a product on each scheduler, the clock it assumes
    (the card's maximum)."""
    from kokoro_tpu_torch.ops import kernels

    build_dir.mkdir(parents=True, exist_ok=True)
    src, exe = build_dir / "probe_tf32.cu", build_dir / "probe_tf32"
    src.write_text(PROBE)
    subprocess.run([kernels.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", str(exe), str(src)], check=True, capture_output=True, timeout=300)
    lines = subprocess.run([str(exe)], check=True, capture_output=True, text=True,
                           timeout=120).stdout.split("\n")
    keys = ("chains", "warps", "ctas_per_sm", "ms", "tf32_tflops", "cycles_per_mma",
            "clock_mhz")
    return [dict(zip(keys, (float(x) for x in ln.split()))) for ln in lines if ln.strip()]


def sass_loops(sass: str) -> dict:
    """``{kernel: [{"instructions": n, "mma": m}, ...]}`` for the f32
    backward kernels: every loop (a backward branch and its target) that
    issues ``HMMA``, innermost first."""
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        if "4tf32" not in name:
            continue
        code = []
        for ln in block.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
            if m:
                code.append((int(m.group(1), 16), m.group(2)))
        loops = []
        for i, (addr, ins) in enumerate(code):
            m = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)", ins)
            if m and int(m.group(1), 16) < addr:
                body = [x for a, x in code if int(m.group(1), 16) <= a <= addr]
                mma = sum("HMMA" in x for x in body)
                if mma:
                    loops.append({"instructions": len(body), "mma": mma})
        out[name] = sorted(loops, key=lambda x: x["instructions"])
    return out


def sass_census() -> dict:
    from kokoro_tpu_torch.ops import kernels

    lib = kernels.build_all()["packed_attention_bwd"]
    cuobjdump = Path(kernels.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    return sass_loops(sass)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    from kokoro_tpu_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    result = {"nvidia_smi": smi, "mma_sync_tf32": mma_probe(kernels.BUILD_DIR / "probe"),
              "sass_loops": sass_census()}
    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
