"""``repro_torch.comm`` — the communication policies (port of
``repro.comm``): GD, LAG-WK (15a), LAG-PS (15b) and LAQ, built from a spec
string by :func:`make_policy`.  Schedules (``cyc-``/``num-``) and LASG-WK
are not ported yet.
"""
from repro_torch.comm.base import (CommPolicy, CommRound, PolicyState,
                                   run_round)
from repro_torch.comm.laq import LAQPolicy
from repro_torch.comm.policies import GDPolicy, LAGPSPolicy, LAGWKPolicy

POLICIES = {
    "gd": GDPolicy,
    "lag-wk": LAGWKPolicy,
    "lag-ps": LAGPSPolicy,
    "laq": LAQPolicy,
}


def make_policy(spec: str, *, bits: int = 4, fastpath="auto") -> CommPolicy:
    """Build a policy from ``<algo>[@<bits>]`` (``"lag-wk"``, ``"laq@8"``).

    ``fastpath``: ``"auto"`` (the plane is on for CUDA tensors; CPU
    tensors take the plain per-leaf route) or ``"on"`` (forced, plain
    kernel versions on CPU tensors).
    """
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"policy spec must be a non-empty string, got "
                         f"{spec!r}")
    name, sep, param = spec.partition("@")
    name = name.strip()
    if name not in POLICIES:
        raise ValueError(f"unknown comm policy {spec!r}; the port has: "
                         f"{tuple(POLICIES)} ('laq@<bits>' for LAQ)")
    cls = POLICIES[name]
    if sep:
        if cls is not LAQPolicy:
            raise ValueError(f"bad policy spec {spec!r}: only 'laq' takes an "
                             f"'@<bits>' parameter")
        try:
            bits = int(param)
        except ValueError:
            raise ValueError(f"bad policy spec {spec!r}: '@{param}' is not "
                             f"an integer bit width") from None
    if cls is LAQPolicy:
        return LAQPolicy(bits=bits, fastpath=fastpath)
    return cls(fastpath=fastpath)


__all__ = ["CommPolicy", "CommRound", "PolicyState", "run_round",
           "make_policy", "POLICIES", "GDPolicy", "LAGWKPolicy",
           "LAGPSPolicy", "LAQPolicy"]
