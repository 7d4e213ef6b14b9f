"""``repro_torch.comm`` — the communication policies (port of
``repro.comm``): GD, LAG-WK (15a), LAG-PS (15b), LAQ, LASG-WK and any of
them under a cyclic or sampled schedule (cyc-IAG, num-IAG, cyc-LAQ, …),
built from a spec string by :func:`make_policy`.
"""
from repro_torch.comm.base import CommPolicy, CommRound, PolicyState
from repro_torch.comm.laq import LAQPolicy
from repro_torch.comm.policies import (GDPolicy, LAGPSPolicy, LAGWKPolicy,
                                       LASGWKPolicy)
from repro_torch.comm.schedule import (CyclicSchedule, SampledSchedule,
                                       Schedule, ScheduledPolicy)
from repro_torch.fastpath.plan import make_plan

# algo name → policy class; the trainer's adam aliases reuse the matching
# trigger (the server step is the engine's axis, not the policy's)
POLICIES = {
    "gd": GDPolicy,
    "lag-wk": LAGWKPolicy,
    "lag-ps": LAGPSPolicy,
    "laq": LAQPolicy,
    "lasg-wk": LASGWKPolicy,
    "adam": GDPolicy,
    "lag-adam": LAGWKPolicy,
}

# schedule prefix → Schedule factory (probs only reaches sampled schedules)
SCHEDULES = {
    "cyc": lambda probs: CyclicSchedule(),
    "num": lambda probs: SampledSchedule(probs),
}


def _parse_spec(spec: str):
    """``"name@param"`` → (name, param-str-or-None)."""
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"policy spec must be a non-empty string, got "
                         f"{spec!r}")
    name, sep, param = spec.partition("@")
    return name.strip(), (param.strip() if sep else None)


def make_policy(spec: str, *, bits: int = 4, use_pallas: bool = False,
                sqnorm_fn=None, probs=None, fastpath="auto") -> CommPolicy:
    """Build a policy from ``[cyc-|num-]<algo>[@<bits>]``.

    ``<algo>`` is a key of :data:`POLICIES`; ``iag`` (the GD payload) only
    under a schedule prefix.  ``@<bits>`` is LAQ's width and beats the
    ``bits`` keyword.  ``cyc-``/``num-`` wrap the payload in a
    :class:`ScheduledPolicy` with a cyclic / sampled schedule; ``probs``
    feeds the sampled one (uniform when omitted).

    ``fastpath``: ``"auto"`` (the plane is on for CUDA tensors; CPU
    tensors take the plain per-leaf route), ``"on"`` (forced, plain
    kernel versions on CPU tensors) or None (no plan: the plain route on
    every device — what the convex driver selects for a float64 problem,
    which the float32 plane cannot serve).  ``use_pallas=True`` SELECTS the
    legacy per-leaf route instead: the policy gets no plane, LAQ encodes
    with the per-leaf kernels of ``repro_torch.kernels.lag_trigger``, and
    ``sqnorm_fn`` (when given) replaces the triggers' squared norm.
    Combined with ``fastpath="on"`` it raises.
    """
    name, param = _parse_spec(spec)

    schedule = None
    for prefix, sched_fn in SCHEDULES.items():
        if name.startswith(prefix + "-"):
            schedule = sched_fn(probs)
            name = name[len(prefix) + 1:]
            break
    if schedule is not None and name == "iag":
        name = "gd"   # IAG = the dense GD payload under a schedule
    elif name == "iag" or name.endswith("-iag"):
        raise ValueError(
            f"unknown comm policy {spec!r}: IAG baselines are spelled "
            f"'cyc-iag' or 'num-iag' (a schedule prefix over the GD "
            f"payload)")

    if name not in POLICIES:
        raise ValueError(
            f"unknown comm policy {spec!r}; known algos: "
            f"{tuple(POLICIES)}, optionally prefixed with "
            f"{tuple(p + '-' for p in SCHEDULES)} and suffixed with "
            f"'@<bits>' for laq")
    cls = POLICIES[name]

    if param is not None:
        if cls is not LAQPolicy:
            raise ValueError(
                f"bad policy spec {spec!r}: only 'laq' takes an '@<bits>' "
                f"parameter ({name!r} has no spec parameter)")
        try:
            bits = int(param)
        except ValueError:
            raise ValueError(
                f"bad policy spec {spec!r}: '@{param}' is not an integer "
                f"bit width (want e.g. 'laq@8')") from None

    if fastpath is not None:
        make_plan(fastpath)                        # validate the mode
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
    policy = cls(**kw)
    if schedule is not None:
        policy = ScheduledPolicy(policy, schedule)
    return policy


__all__ = ["CommPolicy", "CommRound", "PolicyState", "make_policy",
           "POLICIES", "SCHEDULES", "GDPolicy", "LAGWKPolicy", "LAGPSPolicy",
           "LAQPolicy", "LASGWKPolicy", "Schedule", "CyclicSchedule",
           "SampledSchedule", "ScheduledPolicy"]
