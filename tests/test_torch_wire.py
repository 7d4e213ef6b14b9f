"""The collective wire format of the port's policies against the LIVE JAX
reference (``repro.comm``'s ``wire_pack``/``wire_unpack``/
``wire_slot_bytes``, ``repro.devrun.verify``'s accounting).

The reference's own in-process cases (``tests/test_devrun.py``): W = 4
workers, a template of three leaves, one round of ``policy_rounds(...,
wire_layout=)`` at eight ``(spec, hist_scale)`` points — every worker
uploading, an all-quiet round, LAQ at 3, 4, 8 and 16 bits, a cyclic
schedule's one uploader.  Both sides start from the same numpy gradients.
The reference runs its plane (``fastpath="on"``, Pallas in interpret
mode): its oracle route divides the scale by the constant qmax, which
XLA's CPU backend turns into a multiply by the reciprocal, so its
quantizer steps there are off the IEEE quotient by an ulp for most
(worker, leaf) pairs; the plane's steps are the IEEE quotient, as the
port's on both routes (``test_torch_layout_plan``).
The port's wire tensors are bitwise the reference's (the packed codes, the
quantizer steps, the masked float32 buffer), on the plain route and on the
forced plane, and unpacking them and summing in worker order is bitwise the
reference's ``sum_reduce``.  The accounting is exact: slot bytes are the
tensors' ``nbytes``, and ``framing_ratio`` and the slot and gather terms
of ``predicted_collective_bytes`` equal the reference's, on that template
and on the reduced llama3.2-1b.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro import devrun as jdevrun
from repro.core import lag as jlag
from repro.engine import rounds as jrounds
from repro.fastpath.layout import FlatLayout as JFlatLayout

from repro_torch import comm
from repro_torch import devrun
from repro_torch.comm.laq import pack_codes, unpack_codes, wire_code_width
from repro_torch.core import lag
from repro_torch.engine import rounds
from repro_torch.fastpath.layout import FlatLayout

W = 4
CASES = [("gd", 0.0), ("lag-wk", 0.0), ("lag-wk", 1e9), ("laq@4", 0.0),
         ("laq@3", 0.0), ("laq@8", 1e9), ("laq@16", 0.0),
         ("cyc-laq@8", 0.0)]


def template():
    return {"w": np.zeros((37, 5), np.float32),
            "b": np.zeros((63,), np.float32),
            "s": np.zeros((), np.float32)}


def grads_np(W=W):
    key = jax.random.PRNGKey(7)
    return {k: np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                            (W,) + v.shape, jnp.float32))
            for i, (k, v) in enumerate(sorted(template().items()))}


def reference_round(spec, hist_scale, grads):
    params = {k: jnp.asarray(v) for k, v in template().items()}
    policy = jcomm.make_policy(spec, fastpath="on")
    z = lambda p: jnp.zeros((W,) + p.shape, p.dtype)
    st = dict(policy.init_state(jax.tree_util.tree_map(z, params),
                                jax.tree_util.tree_map(z, params)
                                if policy.needs_theta_hat else None))
    st.update(hist=jlag.hist_init(10) + hist_scale,
              L_m=jnp.full((W,), 2.0, jnp.float32))
    lagcfg = jlag.LAGConfig(num_workers=W, alpha=0.1, D=10, xi=0.1)
    layout = JFlatLayout.for_tree(params)
    comm_m, delta, _, wire = jrounds.policy_rounds(
        policy, lagcfg, params, {k: jnp.asarray(v) for k, v in grads.items()},
        st, step=jnp.asarray(1, jnp.int32), wire_layout=layout)
    ref = jrounds.sum_reduce(comm_m, delta)
    return (np.asarray(comm_m), {k: np.asarray(v) for k, v in wire.items()},
            {k: np.asarray(v) for k, v in ref.items()})


def port_round(spec, hist_scale, grads, fastpath):
    tmpl = {k: torch.from_numpy(v) for k, v in template().items()}
    lo = FlatLayout.for_tree(tmpl)
    policy = comm.make_policy(spec, fastpath=fastpath)
    st = dict(policy.init_state(lo.empty((W,)), lo.empty((W,))
                                if policy.needs_theta_hat else None))
    st.update(hist=lag.hist_init(10) + hist_scale,
              L_m=torch.full((W,), 2.0))
    lagcfg = lag.LAGConfig(num_workers=W, alpha=0.1, D=10, xi=0.1)
    g = lo.flatten_stacked({k: torch.from_numpy(v.copy())
                            for k, v in grads.items()})
    comm_m, delta, _, wire = rounds.policy_rounds(
        policy, lagcfg, lo.flatten(tmpl), g, st, lo, step=1,
        wire_layout=lo)
    return policy, lo, comm_m, wire


@pytest.fixture(scope="module")
def reference_cases():
    grads = grads_np()
    return grads, {c: reference_round(*c, grads) for c in CASES}


@pytest.mark.parametrize("fastpath", [None, "on"], ids=["plain", "plane"])
@pytest.mark.parametrize("spec,hist_scale", CASES)
def test_wire_tensors_and_sum_bitwise_the_reference(reference_cases, spec,
                                                    hist_scale, fastpath):
    grads, ref = reference_cases
    jmask, jwire, jsum = ref[(spec, hist_scale)]
    policy, lo, mask, wire = port_round(spec, hist_scale, grads, fastpath)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    if hist_scale:
        assert not jmask.any()
    assert set(wire) == set(jwire)
    for k, v in wire.items():
        assert v.shape == jwire[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(jwire[k].dtype), k
        np.testing.assert_array_equal(v.numpy(), jwire[k], err_msg=k)
    # the device plane's reduction: unpack, sum in worker order, unflatten
    buf = policy.wire_unpack(lo, wire)
    got = lo.unflatten(rounds.sum_reduce(mask, buf), like=torch.float32)
    for k in jsum:
        np.testing.assert_array_equal(got[k].numpy(), jsum[k], err_msg=k)
    # and row chunks of whole blocks unpack to the same rows
    for rs in (slice(0, 256), slice(256, lo.rows)):
        part = policy.wire_unpack(lo, wire, rows=rs)
        assert torch.equal(part, buf[:, rs])


@pytest.mark.parametrize("spec", ["gd", "lag-wk", "laq@3", "laq@4", "laq@8",
                                  "laq@16", "cyc-laq@8"])
def test_slot_bytes_are_the_tensors_nbytes(spec):
    grads = grads_np()
    policy, lo, _, wire = port_round(spec, 0.0, grads, None)
    slots = policy.wire_slot_bytes(lo)
    assert set(slots) == set(wire)
    for k, v in wire.items():
        assert v.numel() * v.element_size() // W == slots[k], (spec, k)
    jpolicy = jcomm.make_policy(spec, fastpath="off")
    jlo = JFlatLayout.for_tree({k: jnp.asarray(v)
                                for k, v in template().items()})
    assert slots == jpolicy.wire_slot_bytes(jlo)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 8, 9, 16])
def test_pack_codes_round_trip_is_bitwise(bits):
    """Codes of every magnitude, masked workers, and rows packed in chunks
    smaller than the buffer (a chunk size that does not divide it)."""
    import repro_torch.comm.laq as laq
    lo = FlatLayout.for_tree({"a": torch.zeros(40000), "b": torch.zeros(7, 9)})
    assert lo.rows == 512
    qmax = float(2 ** (bits - 1) - 1)
    gen = torch.Generator().manual_seed(bits)
    steps = torch.rand((3, lo.num_leaves), generator=gen) + 0.1
    codes = torch.randint(-int(qmax), int(qmax) + 1, (3, lo.rows, 128),
                          generator=gen).float()
    payload = codes * laq._step_rows(lo, steps)[:, :, None]
    mask = torch.tensor([True, False, True])
    chunk = laq.CHUNK_ROWS
    try:
        laq.CHUNK_ROWS = 256
        packed, stw = pack_codes(lo, payload, steps, bits, mask)
    finally:
        laq.CHUNK_ROWS = chunk
    width = wire_code_width(bits)
    assert packed.dtype == (torch.uint16 if width == 16 else torch.uint8)
    got = unpack_codes(lo, packed, stw, bits)
    assert torch.equal(got[0], payload[0]) and torch.equal(got[2], payload[2])
    assert not got[1].any()
    whole, _ = pack_codes(lo, payload, steps, bits, mask)
    assert torch.equal(whole, packed)


def test_framing_and_prediction_equal_the_reference():
    from repro.configs import get_config as jget_config
    from repro.models import model as jmodel
    from repro_torch.configs import get_config
    from repro_torch.models import model

    jtmpl = {k: jnp.asarray(v) for k, v in template().items()}
    tmpl = {k: torch.from_numpy(v) for k, v in template().items()}
    jcfg = jget_config("llama3.2-1b").reduced(dtype="float32",
                                              param_dtype="float32")
    jparams = jax.eval_shape(lambda k: jmodel.init(k, jcfg),
                             jax.random.PRNGKey(0))
    params = model.templates(get_config("llama3.2-1b").reduced())
    for spec in ("gd", "lag-wk", "laq@3", "laq@4", "laq@8", "laq@16",
                 "cyc-laq@8"):
        jpol = jcomm.make_policy(spec, fastpath="off")
        pol = comm.make_policy(spec)
        for jp, p in ((jtmpl, tmpl), (jparams, params)):
            assert devrun.framing_ratio(pol, p) \
                == jdevrun.framing_ratio(jpol, jp), spec
            for n in (1, 2, 4, 8):
                got = devrun.predicted_collective_bytes(pol, p, n)
                want = jdevrun.predicted_collective_bytes(jpol, jp, n)
                for k in ("slots", "slot_total", "gather_bytes",
                          "mask_bytes"):
                    assert got[k] == want[k], (spec, n, k)
                # the loss side channel is what each moves: the port
                # gathers n float32 losses, the reference all-reduces one
                assert got["loss_bytes"] == 4.0 * (n - 1)
                assert want["loss_bytes"] == 2.0 * 4.0 * (n - 1) / n
                assert got["total"] == got["gather_bytes"] \
                    + got["mask_bytes"] + got["loss_bytes"]
