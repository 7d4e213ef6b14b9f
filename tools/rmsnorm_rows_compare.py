"""Compare the RMSNorm rows kernel of two ``rmsnorm.cu`` sources on the card.

For each source: every rows-kernel instantiation's SASS instruction mix
(``cuobjdump -sass``: global loads LDG, shared loads LDS, conversions F2FP
and HADD2, ...), then the ``lag_rmsnorm_rows_*`` entries' CUDA-event times
at (8192, d) for d in 4099 and 20000 in all three dtypes, the two sources
in turns (a, b, a, b) on the same inputs.  Needs ``nvcc`` and a card:

    git show <commit>:src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu \\
        > build/rmsnorm_a.cu
    python tools/rmsnorm_rows_compare.py build/rmsnorm_a.cu \\
        src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu
"""
import collections
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.device import gpu_name_and_power_limit  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm as rms  # noqa: E402

OPS = ("LDG", "LDS", "STG", "STS", "F2FP", "HADD2", "PRMT", "FFMA", "SHF",
       "IMAD", "BAR", "SYNCS")


def sass_mix(path: Path):
    """{rows-kernel function: (instructions, {opcode: count})}."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for func in sass.split("Function : ")[1:]:
        name = func.split("\n", 1)[0]
        if "rows" not in name:
            continue
        ops = collections.Counter(re.findall(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T\d]\s+)?([A-Z0-9_]+)", func))
        out[name] = (sum(ops.values()), {k: ops[k] for k in OPS if ops[k]})
    return out


def cuda_ms(fn, n=20):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def main(argv):
    if len(argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    libs = [dataclasses.replace(rms.LIBRARY, name=f"rmsnorm_cmp{i}",
                                source=Path(src).resolve())
            for i, src in enumerate(argv)]
    build.build(libs)
    print(gpu_name_and_power_limit())
    for src, lib in zip(argv, libs):
        for name, (total, ops) in sass_mix(lib.path()).items():
            print(f"{src}: {name[:100]}: {total} instructions {ops}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for d in (4099, 20000):
        for dt, sfx in ((torch.bfloat16, "bf16"), (torch.float16, "f16"),
                        (torch.float32, "f32")):
            x = torch.randn((8192, d), device=dev, generator=gen).to(dt)
            s = torch.randn((d,), device=dev, generator=gen).to(dt)
            y = torch.empty_like(x)
            fns = [getattr(build.load(lib), f"lag_rmsnorm_rows_{sfx}")
                   for lib in libs]
            t = [cuda_ms(lambda: build.launch(
                fn, x.data_ptr(), s.data_ptr(), y.data_ptr(), 8192, d, 1e-6,
                device=dev)) for fn in fns + fns]
            print(f"(8192, {d}) {sfx}: a {t[0]:.4f} / {t[2]:.4f} ms, "
                  f"b {t[1]:.4f} / {t[3]:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
