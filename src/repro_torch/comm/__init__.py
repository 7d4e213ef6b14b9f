"""``repro_torch.comm`` — the communication policies (port of
``repro.comm``): GD, LAG-WK (15a), LAG-PS (15b) and LAQ, built from a spec
string by :func:`make_policy`.  Schedules (``cyc-``/``num-``) and LASG-WK
are not ported yet.
"""
from repro_torch.comm.base import (CommPolicy, CommRound, PolicyState,
                                   run_round)
from repro_torch.comm.laq import LAQPolicy
from repro_torch.comm.policies import GDPolicy, LAGPSPolicy, LAGWKPolicy
from repro_torch.fastpath.plan import make_plan

POLICIES = {
    "gd": GDPolicy,
    "lag-wk": LAGWKPolicy,
    "lag-ps": LAGPSPolicy,
    "laq": LAQPolicy,
}


def make_policy(spec: str, *, bits: int = 4, use_pallas: bool = False,
                sqnorm_fn=None, fastpath="auto") -> CommPolicy:
    """Build a policy from ``<algo>[@<bits>]`` (``"lag-wk"``, ``"laq@8"``).

    ``fastpath``: ``"auto"`` (the plane is on for CUDA tensors; CPU
    tensors take the plain per-leaf route) or ``"on"`` (forced, plain
    kernel versions on CPU tensors).  ``use_pallas=True`` SELECTS the
    legacy per-leaf route instead: the policy gets no plane, LAQ encodes
    with the per-leaf kernels of ``repro_torch.kernels.lag_trigger``, and
    ``sqnorm_fn`` (when given) replaces the triggers' squared norm.
    Combined with ``fastpath="on"`` it raises.
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
    make_plan(fastpath)                            # validate the mode
    if use_pallas:
        if fastpath == "on":
            raise ValueError(
                "conflicting comm-plane configs: use_pallas=True selects "
                "the legacy per-leaf kernels but fastpath='on' forces the "
                "batched plane (repro_torch.fastpath) — pass one of them")
        fastpath = None
    kw = {"fastpath": fastpath}
    if sqnorm_fn is not None:
        kw["sqnorm_fn"] = sqnorm_fn
    if cls is LAQPolicy:
        kw.update(bits=bits, use_pallas=use_pallas)
    return cls(**kw)


__all__ = ["CommPolicy", "CommRound", "PolicyState", "run_round",
           "make_policy", "POLICIES", "GDPolicy", "LAGWKPolicy",
           "LAGPSPolicy", "LAQPolicy"]
