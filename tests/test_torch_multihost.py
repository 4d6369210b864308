"""rtwc_tpu_torch.dist.initialize_multihost across 2 local processes on the
CPU (the port's tests/test_multihost.py): each process is one rank of a
gloo group, renders one band of the shadowed, animated train step on the
kernel path (the kernels' plain versions on the CPU) and crosses the
process boundary in the step's all-reduce. The ranks are the scaling
entry point's own (`python -m rtwc_tpu_torch.benchmarks.scaling` with its
hidden --rank / --world / --coordinator flags), each under a 120 s
timeout. Their LOSS lines must agree bit for bit, as must their
parameters, and the entry point's row built from their records says so.
"""
import json
import os
import subprocess
import sys

from rtwc_tpu_torch.benchmarks import scaling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_sharded_train_step():
    coordinator = f"127.0.0.1:{scaling._free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    args = ["--width", "64", "--height", "32", "--spheres", "4", "--iters", "1",
            "--world", "2", "--coordinator", coordinator, "--device", "cpu"]
    procs = [subprocess.Popen([sys.executable, "-m", "rtwc_tpu_torch.benchmarks.scaling",
                               "--rank", str(r)] + args,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=ROOT, env=env)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed rc={p.returncode}\n{out}\n{err}"
    losses = [ln.split()[1] for out, _ in outs for ln in out.splitlines()
              if ln.startswith("LOSS ")]
    assert len(losses) == 2 and losses[0] == losses[1], losses
    recs = [json.loads(ln[5:]) for out, _ in outs for ln in out.splitlines()
            if ln.startswith("RANK ")]
    assert [r["rank"] for r in recs] == [0, 1]
    row = scaling._row(2, recs, 64 * 32)
    assert row["losses_bit_equal"] and row["params_bit_equal"], row
    assert row["rank_losses"] == losses and float.fromhex(losses[0]) == row["losses"][-1] > 0
