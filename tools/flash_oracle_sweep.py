"""Hold the 2-byte flash kernels against two oracles on the card.

For random float16 inputs (seeds 0..N-1) at head_dim 64, 256 and 320 (the
wide kernel), causal with a window of 16 and of 64, compare the kernel with
the plain version on the widened inputs rounded to float16, its P·V in
float32 and in float64, within one float16 ulp + 1e-6.  For each launch
where the float32 oracle refuses the kernel, print one refused element:
the kernel, both oracles, and the float32 kernel on the same inputs.

    python tools/flash_oracle_sweep.py [N]      # on the card; N = 40
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.device import gpu_name_and_power_limit  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402,E501
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402

CASES = ((64, 32, 8), (256, 16, 1), (320, 4, 2))       # head_dim, H, KV
SHAPES = ((127, 16), (1000, 16), (200, 64))            # S, window


def f16_ulp(x):
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       torch.clamp(e, min=-13) - 11)


def refused(got, want):
    bound = f16_ulp(torch.maximum(got.abs(), want.abs())) + 1e-6
    return (got - want).abs() > bound


def main(n):
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(gpu_name_and_power_limit())
    dev = torch.device("cuda")
    launches = fails32 = fails64 = 0
    for seed in range(n):
        g = torch.Generator(device=dev).manual_seed(seed)
        for hd, H, KV in CASES:
            for S, win in SHAPES:
                q = torch.randn((1, S, H, hd), device=dev, generator=g)
                k = torch.randn((1, S, KV, hd), device=dev, generator=g)
                v = torch.randn((1, S, KV, hd), device=dev, generator=g)
                q, k, v = q.half(), k.half(), v.half()
                got = fa.flash_attention_fwd(q, k, v, causal=True,
                                             window=win).float()
                w32 = fa_ref.attention(q.float(), k.float(), v.float(),
                                       causal=True, window=win)
                w64 = fa_ref.attention(q.double(), k.double(), v.double(),
                                       causal=True, window=win)
                launches += 1
                bad64 = refused(got, w64.half().float())
                fails64 += bool(bad64.any())
                bad = refused(got, w32.half().float())
                if not bad.any():
                    continue
                fails32 += 1
                i = tuple(bad.nonzero()[0].tolist())
                k32 = fa.flash_attention_fwd(q.float(), k.float(), v.float(),
                                             causal=True, window=win)
                print(f"seed {seed} hd {hd} S {S} window {win}: "
                      f"{int(bad.sum())} refused by the float32 oracle; at "
                      f"{i}: kernel {got[i].item():.8f}, float32 oracle "
                      f"{w32[i].item():.8f}, float64 oracle "
                      f"{w64[i].item():.8f}, float32 kernel "
                      f"{k32[i].item():.8f}")
    print(f"{launches} launches: {fails32} refused by the float32 oracle, "
          f"{fails64} by the float64 one")
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 40))
