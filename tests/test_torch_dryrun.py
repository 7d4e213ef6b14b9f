"""The one-card dry-run (``repro_torch.launch.dryrun``) and the examples.

- ``count_params`` and ``arch_worker_count`` equal the reference's for all
  eleven architectures.  The reference's module sets ``XLA_FLAGS`` to 512
  host devices when it is imported, so it runs in a subprocess of its own.
- The meta reckoning on reduced configs: a training step's state bytes are
  the CPU ``init_state``'s buffers, tree by tree, and its FLOPs the CPU
  step's (``FlopCounterMode``); a prefill's and a decode step's peak is
  the same live-bytes count of the same call on CPU tensors, byte for
  byte (the serving path has no plane wrapper in it); the training peak
  holds the W gradients and the W payloads of the round; ``max_layers``
  is the largest depth under the budget.
- The CLI: one ``[status ] arch × shape × one_card`` line per
  combination, ``done (n failures)``, one JSON file each with the
  reference's keys where they carry over.
- The examples run on the CPU at tiny sizes (``--device cpu``), each in a
  subprocess.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.shapes import input_specs
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import TokenStream, make_inputs
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step)
from repro_torch.launch import dryrun
from repro_torch.models import model

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")


def test_param_and_worker_counts_match_the_reference():
    code = ("import json\n"
            "from repro.launch import dryrun as d\n"
            "from repro.configs import ALL_ARCHS\n"
            "out = {}\n"
            "for a in ALL_ARCHS:\n"
            "    n = d.count_params(d.dryrun_config(a))\n"
            "    out[a] = [n, d.arch_worker_count(n)]\n"
            "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    assert sorted(ref) == sorted(ALL_ARCHS)
    for arch in ALL_ARCHS:
        n = dryrun.count_params(dryrun.dryrun_config(arch))
        assert [n, dryrun.arch_worker_count(n)] == ref[arch], arch
    assert dryrun.dryrun_config("qwen3-moe-30b-a3b").moe_seq_shards == 16


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_training_reckoning_on_a_reduced_config(dt):
    cfg = get_config("llama3.2-1b", dtype=dt, param_dtype=dt).reduced()
    tcfg = TrainerConfig(algo="lag-wk", num_workers=2, lr=0.3)
    rec = dryrun.reckon(cfg, "train_4k", 2, batch=4, seq=32, tcfg=tcfg)
    mem = rec["memory"]
    st = init_state(cfg, tcfg, device="cpu")
    want = {"theta": st["theta"].nbytes}
    want.update({f"lag.{k}": v.nbytes for k, v in st["lag"].items()})
    assert mem["state_bytes"] == want
    tree = st["theta"].nbytes
    assert mem["input_bytes"] == 2 * 4 * 32 * 4          # tokens + targets
    assert mem["argument_size_in_bytes"] == sum(want.values()) \
        + mem["input_bytes"]
    # the round holds the W gradients and the W payloads at once
    assert mem["temp_size_in_bytes"] >= 4 * tree
    assert mem["peak_bytes"] == mem["argument_size_in_bytes"] \
        + mem["temp_size_in_bytes"]
    assert mem["saved_activation_bytes"] > 0
    # the same step's FLOPs on CPU tensors
    step = make_train_step(cfg, tcfg.replace(fastpath="on"))
    batch = make_inputs(cfg, TokenStream(cfg.vocab_size), 0, 4, 32,
                        device="cpu")
    with torch.utils.flop_counter.FlopCounterMode(display=False) as fc:
        step(init_state(cfg, tcfg.replace(fastpath="on"), device="cpu"),
             batch)
    assert rec["cost"]["flops"] == fc.get_total_flops() > 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-9b",
                                  "mamba2-370m", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serving_reckoning_is_the_cpu_runs_count(arch, shape):
    """The meta reckoning's peak and FLOPs equal the same counters on the
    same call with CPU tensors."""
    cfg = get_config(arch, **BF16).reduced()
    rec = dryrun.reckon(cfg, shape, 1, batch=2, seq=64)
    zeros = lambda t: torch.zeros(t.shape, dtype=t.dtype)
    params = tree_map(zeros, model.templates(cfg))
    cpu_in = {k: zeros(v) if isinstance(v, torch.Tensor) else v
              for k, v in input_specs(cfg, shape, 2, 64).items()}
    if shape.startswith("prefill"):
        run = lambda: model.prefill(params, cfg, cpu_in, max_len=64)
        external = tree_leaves(params) + tree_leaves(cpu_in)
    else:
        cache = model.init_cache(cfg, 2, 64, device="cpu")
        run = lambda: model.decode_step(params, cfg, cache, cpu_in["tokens"],
                                        cpu_in["pos"])
        external = tree_leaves(params) + tree_leaves(cache) \
            + [cpu_in["tokens"]]
    temp, _, flops = dryrun._measure(run, external, grad=False)
    assert rec["memory"]["temp_size_in_bytes"] == temp > 0
    assert rec["cost"]["flops"] == flops


def test_max_layers_is_the_deepest_cut_under_the_budget():
    cfg = get_config("llama3.2-1b", **BF16).reduced(num_layers=4)
    kw = dict(batch=4, seq=32)
    peaks = [dryrun.reckon(cfg.replace(num_layers=n), "train_4k", 2,
                           **kw)["memory"]["peak_bytes"]
             for n in range(1, 5)]
    assert peaks == sorted(peaks) and peaks[0] < peaks[-1]
    for n in range(1, 5):
        assert dryrun.max_layers(cfg, "train_4k", 2, peaks[n - 1],
                                 **kw) == n
        assert dryrun.max_layers(cfg, "train_4k", 2, peaks[n - 1] - 1,
                                 **kw) == n - 1


def test_cli_lines_and_json_records(tmp_path, capsys):
    n_fail = dryrun.main(["--arch", "all", "--shape", "all", "--reduced",
                          "--batch", "4", "--seq", "32", "--workers", "2",
                          "--out", str(tmp_path)])
    assert n_fail == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "done (0 failures)"
    pat = re.compile(r"^\[(ok     |skipped|error  )\] (\S+) × (\S+) × "
                     r"one_card( .*)?$")
    recs = {}
    for line in lines[:-1]:
        m = pat.match(line)
        assert m, line
        recs[(m.group(2), m.group(3))] = m.group(1).strip()
    assert len(recs) == 10 * 4                     # ASSIGNED × SHAPES
    for (arch, shape), status in recs.items():
        rec = json.loads((tmp_path / f"{arch}_{shape}_one_card.json")
                         .read_text())
        assert rec["status"] == status and rec["mesh"] == "one_card"
        if status == "ok":
            assert {"argument_size_in_bytes", "temp_size_in_bytes",
                    "peak_bytes", "state_bytes"} <= set(rec["memory"])
            assert rec["cost"]["flops"] > 0 and rec["fits"] is True
            assert rec["max_layers"] == rec["num_layers"]
            assert ("workers" in rec) == (shape == "train_4k")
        else:
            assert rec["reason"]
    # the mixed trees' training is reckoned, its state in two parts
    for arch in ("mamba2-370m", "recurrentgemma-9b", "qwen3-moe-30b-a3b",
                 "qwen3-moe-235b-a22b"):
        rec = json.loads((tmp_path / f"{arch}_train_4k_one_card.json")
                         .read_text())
        assert rec["status"] == "ok" and rec["max_layers"] \
            == rec["num_layers"], rec.get("reason")
        assert rec["memory"]["state_bytes"]["theta"] > 0


def test_cli_dtype_float16_records(tmp_path):
    """``--dtype float16`` reckons the float16 config: records of their
    own (``_float16`` in the name, ``"dtype"``), θ at the bfloat16 config's
    bytes (both 2-byte trees), float32 parts kept as float32."""
    args = ["--shape", "train_4k", "--reduced", "--batch", "4", "--seq",
            "32", "--workers", "2", "--out", str(tmp_path)]
    for arch in ("llama3.2-1b", "mamba2-370m"):
        assert dryrun.main(["--arch", arch, *args]) == 0
        assert dryrun.main(["--arch", arch, "--dtype", "float16", *args]) == 0
        bf = json.loads((tmp_path / f"{arch}_train_4k_one_card.json")
                        .read_text())
        fh = json.loads((tmp_path / f"{arch}_train_4k_one_card_float16.json")
                        .read_text())
        assert (bf["dtype"], fh["dtype"]) == ("bfloat16", "float16")
        assert fh["status"] == "ok" and fh["fits"] is True
        assert fh["memory"]["state_bytes"]["theta"] \
            == bf["memory"]["state_bytes"]["theta"]
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "llama3.2-1b", "--dtype", "float32", *args])



# ---------------------------------------------------------------------------
# The examples, on the CPU at tiny sizes
# ---------------------------------------------------------------------------

EXAMPLES = {
    "torch_quickstart.py": (["--steps", "150"], "wire bytes to 1e-8"),
    "torch_serve_batched.py": (["--batch", "2", "--prompt-len", "8",
                                "--gen", "4"], "ms/token"),
    "torch_train_lag_llm.py": (["--steps", "2", "--layers", "1",
                                "--workers", "2", "--batch", "2", "--seq",
                                "16", "--bfloat16"], "of synchronous GD"),
    "torch_pod_lag_multipod.py": (["--steps", "3"],
                                  "rounds with ZERO cross-pod traffic"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    args, want = EXAMPLES[name]
    env = dict(ENV, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                          "--device", "cpu", *args], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert want in res.stdout
    src = (ROOT / "examples" / name).read_text()
    assert "import jax" not in src and "from repro." not in src \
        and "import repro\n" not in src
