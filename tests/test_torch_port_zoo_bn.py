"""The BatchNorm families ResNet-50 and MobileNet in the port against the
JAX package, on the CPU at crop 64, batch 4; BatchNorm state through the
Solver's update paths, snapshots and SparkNet's tau rounds.

The steps follow ``test_torch_port_zoo.py`` (its helpers, one JAX run a
family); their tolerances are stated, measured and explained above
``HISTORY_REL_L2``: a BatchNorm net's step at seed init with 4 images a
batch is ill-conditioned, so ``test_torch_port_zoo_context.py`` holds its
layers one at a time.

The tau round: two gloo processes (one intra-op thread each) run one
tau-2 round of the serving engine's ``mobilenet`` configuration, 4 images
a worker, from the JAX ``init``'s snapshot; the JAX ``ParallelTrainer``
runs the same round on a 2-device virtual CPU mesh, fed the global
batches.  The loss and the averaged BatchNorm state are held to JAX's at
measured tolerances (``TAU_LOSS_RTOL``, ``TAU_STATE_AREL``), each rank's
history by its relative L2 error (``TAU_HISTORY_REL_L2``), the params and
state to the same round run without the trainer in this process
(``tau_oracle``) at the common tolerance, and the two ranks to each other
bit for bit.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu import models as jm  # noqa: E402
from sparknet_tpu.common import get_config as jget_config  # noqa: E402
from sparknet_tpu.common import set_config as jset_config  # noqa: E402
from sparknet_tpu.models.zoo import GRAPH_SWEEP_FAMILIES as JFAMILIES  # noqa: E402
from sparknet_tpu.parallel import ParallelTrainer as JTrainer  # noqa: E402
from sparknet_tpu.parallel import data_parallel_mesh  # noqa: E402
from sparknet_tpu.solvers.solver import Solver as JSolver  # noqa: E402

from sparknet_tpu_torch import interop, models  # noqa: E402
from sparknet_tpu_torch.common import get_config, set_config  # noqa: E402
from sparknet_tpu_torch.models.zoo import GRAPH_SWEEP_FAMILIES  # noqa: E402
from sparknet_tpu_torch.parallel import local_shard  # noqa: E402
from sparknet_tpu_torch.solvers.solver import Solver  # noqa: E402

from test_torch_port_zoo import (  # noqa: E402
    CLASSES,
    CROP,
    FULL_WIDTH_PARAMS,
    close,
    feeds,
    jax_param_count,
    jax_run,
    port_param_count,
    port_step_matches,
    rel_l2,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = jax_run(name)
        return cache[name]

    return get


@pytest.fixture
def config_back():
    """Put the port's fused_update and storage_dtype back after a test."""
    saved = get_config()
    yield
    set_config(fused_update=saved.fused_update, storage_dtype=saved.storage_dtype)


@pytest.mark.parametrize("name", ["resnet50", "mobilenet"])
def test_full_width_param_count(name):
    got = port_param_count(getattr(models, name)(batch=1))
    assert got == FULL_WIDTH_PARAMS[name]
    assert got == jax_param_count(getattr(jm, name)(batch=1))


# One step of these nets at seed init is ill-conditioned in float32: a
# rounding decides a ReLU otherwise and moves the gradients below it by a
# large share (``test_torch_port_zoo_conditioning.py``: the port's own
# float32 ResNet-50 gradient against float64, 9 ReLUs otherwise, up to 26 %
# of a blob's largest |value|, 3.1e-2 as a relative L2 error; a larger
# batch or crop does not mend it).  Besides, at an input of exactly 0 the
# JAX ReLU passes half the gradient and the port none (one element of
# ResNet-50's res4e_relu on this batch; ``test_torch_port_zoo_context.py``).
# So the layers are held one at a time at the common tolerance in
# ``test_torch_port_zoo_context.py``, and the whole step here by each
# blob's history (the step's update) as a relative L2 error against JAX's
# (measured: 0.077 ResNet-50, 0.052 MobileNet; printed under ``pytest
# -s``), the loss at rtol 1e-4 (measured 4.4e-5), the BatchNorm state at
# rtol 1e-4 + STATE_AREL of its largest |value| (measured 3.3e-4 /
# 3.2e-5); within the port the params move by exactly the history, and the
# fused step equals the per-blob one at the common tolerance.
HISTORY_REL_L2 = 0.15
STATE_AREL = {"resnet50": 1e-3, "mobilenet": 1e-4}


@pytest.fixture(scope="module")
def port_steps(runs):
    """The port's step a (family, fused), held against the JAX run by
    ``port_step_matches``; made on first use."""
    cache = {}

    def get(name, fused):
        if (name, fused) not in cache:
            cache[name, fused] = port_step_matches(
                name, runs(name), fused, loss_rtol=1e-4, state_arel=STATE_AREL[name],
                history_rel_l2=HISTORY_REL_L2)
        return cache[name, fused]

    return get


@pytest.mark.parametrize("fused", [False, True], ids=["per_blob", "fused"])
@pytest.mark.parametrize("name", ["resnet50", "mobilenet"])
def test_sgd_step_and_test_forward_match_jax(name, fused, runs, port_steps):
    """The step against JAX's at the tolerances stated above; the TEST
    forward with global statistics at JAX's weights after the step keeps
    the common tolerance."""
    ps = port_steps(name, fused)
    run = runs(name)
    # one step moved every BatchNorm's statistics: scale_factor 0 -> 1
    sf = {float(s["scale_factor"][0]) for s in ps.variables.state.values()}
    assert sf == {1.0}
    assert len(ps.variables.state) == {"resnet50": 53, "mobilenet": 27}[name]
    for ln, pl in ps.variables.params.items():
        for i, p in enumerate(pl):
            # SGD's first step: w <- w - history
            np.testing.assert_array_equal(
                p.detach().numpy(), run.params0[ln][i] - ps.slots[ln][i][0].detach().numpy())
    if fused:
        blob = port_steps(name, False)
        for ln, pl in ps.variables.params.items():
            for i, p in enumerate(pl):
                close(p.detach().numpy(), blob.variables.params[ln][i].detach().numpy(),
                      f"fused param {ln}[{i}]")
                close(ps.slots[ln][i][0].detach().numpy(),
                      blob.slots[ln][i][0].detach().numpy(), f"fused history {ln}[{i}]")
        for ln, st in ps.variables.state.items():
            for k, t in st.items():
                close(t.numpy(), blob.variables.state[ln][k].numpy(), f"fused state {ln}/{k}")


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_batchnorm_state_stays_out_of_the_arena(storage, config_back, tmp_path):
    """On the fused path BatchNorm state is neither in the param arena nor
    updated by the rule; it stays float32 under bf16 storage, and the
    snapshot carries it under ``state/<layer>/<k>`` both ways."""
    set_config(fused_update=True, storage_dtype=storage)
    s = Solver(models.resnet50_solver(), models.resnet50(batch=2, crop=CROP,
                                                         num_classes=CLASSES),
               device="cpu")
    state_layers = set(s.variables.state)
    assert state_layers and not state_layers & {e.lname for e in s.layout.entries}
    f = feeds(3, batch=2)
    s.step(2, lambda it: f)
    for ln, st in s.variables.state.items():
        assert {k: v.dtype for k, v in st.items()} == dict.fromkeys(
            ("mean", "variance", "scale_factor"), torch.float32), ln
        # two batches' sums: the decayed count 0.999 * 1 + 1
        assert float(st["scale_factor"][0]) == pytest.approx(1.999, rel=1e-6)
    path = interop.solverstate_from_port(s, tmp_path / "r.solverstate.npz")
    with np.load(path) as z:
        keys = set(z.files)
    assert {f"state/{ln}/{k}" for ln in state_layers
            for k in ("mean", "variance", "scale_factor")} <= keys
    back = interop.netvars_from_solverstate(path, device="cpu")
    for ln, st in s.variables.state.items():
        for k, v in st.items():
            assert torch.equal(back.state[ln][k], v)
    # the JAX Solver restores the port's snapshot, BatchNorm state included
    js = JSolver(jm.resnet50_solver(), jm.resnet50(batch=2, crop=CROP,
                                                   num_classes=CLASSES))
    js.restore(path)
    for ln, st in s.variables.state.items():
        for k, v in st.items():
            assert np.array_equal(np.asarray(js.variables.state[ln][k]), v.numpy())


def test_graph_sweep_mobilenet_builds_and_steps():
    fam = GRAPH_SWEEP_FAMILIES["mobilenet"]
    jfam = JFAMILIES["mobilenet"]
    assert fam.solver() == dataclasses.replace(models.mobilenet_solver(), base_lr=1e-3)
    assert (fam.feed, fam.num_classes, fam.image_shape) == (
        jfam.feed, jfam.num_classes, tuple(jfam.image_shape))
    s = Solver(fam.solver(), fam.net(2), device="cpu")
    f = feeds(4, batch=2, classes=fam.num_classes)
    loss = s.step(2, lambda it: f)
    assert np.isfinite(loss)
    assert s.iter == 2


# -- one tau-2 round in a world of two gloo ranks ----------------------------

WORLD = 2
B_LOCAL = 4
TAU = 2
# measured over the round (two steps a rank, then the average) against
# JAX's: the loss 2.0e-5 apart, the state up to 5.3e-4 of a blob's largest
# |value|, each rank's history up to 0.14 as a relative L2 error (median
# 0.048; two ill-conditioned steps, see HISTORY_REL_L2); the params and
# state against the same round without the trainer (``tau_oracle``) at the
# common tolerance (measured: bit for bit)
TAU_LOSS_RTOL, TAU_STATE_AREL, TAU_HISTORY_REL_L2 = 1e-4, 1e-3, 0.3

CHILD = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from sparknet_tpu_torch.models.zoo import GRAPH_SWEEP_FAMILIES
from sparknet_tpu_torch.parallel import ParallelTrainer, initialize_distributed, local_shard
from sparknet_tpu_torch.solvers.solver import Solver

rank, world, work, b_local, tau = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                   int(sys.argv[4]), int(sys.argv[5]))
initialize_distributed(store_path=f"{work}/store", rank=rank, world_size=world,
                       device="cpu")
fam = GRAPH_SWEEP_FAMILIES["mobilenet"]
solver = Solver(fam.solver(), fam.net(b_local), device="cpu")
solver.restore(f"{work}/start.solverstate.npz")
tr = ParallelTrainer(solver, tau=tau)
g = np.load(f"{work}/feeds.npz")
loss = tr.train_round(lambda it: local_shard({k: g[k] for k in ("data", "label")},
                                             rank, world, True))
out = {"loss": np.array(loss)}
v = solver.variables
for ln, pl in v.params.items():
    for i, p in enumerate(pl):
        out[f"param/{ln}/{i}"] = p.detach().numpy()
for ln, s in v.state.items():
    for k, t in s.items():
        out[f"state/{ln}/{k}"] = t.detach().numpy()
for ln, sl in solver.slots.items():
    for i, hl in enumerate(sl):
        for j, h in enumerate(hl):
            out[f"hist/{ln}/{i}/{j}"] = h.detach().numpy()
np.savez(f"{work}/rank{rank}.npz", **out)
dist.destroy_process_group()
"""


def tau_oracle(snap, g) -> dict:
    """The round without the trainer: each rank's TAU steps on its shard of
    ``g`` from the snapshot, in this process on one intra-op thread as the
    workers run, then the mean over the ranks of params and state."""
    saved = get_config()
    threads = torch.get_num_threads()
    set_config(fused_update=False, storage_dtype="f32")
    torch.set_num_threads(1)
    try:
        fam = GRAPH_SWEEP_FAMILIES["mobilenet"]
        outs = []
        for r in range(WORLD):
            s = Solver(fam.solver(), fam.net(B_LOCAL), device="cpu")
            s.restore(snap)
            local = local_shard(g, r, WORLD, True)
            for i in range(TAU):
                s.train_iteration({k: torch.as_tensor(v[i]) for k, v in local.items()})
            v = s.variables
            outs.append({**{f"param/{ln}/{i}": p.detach() for ln, pl in v.params.items()
                            for i, p in enumerate(pl)},
                         **{f"state/{ln}/{k}": t for ln, st in v.state.items()
                            for k, t in st.items()}})
    finally:
        torch.set_num_threads(threads)
        set_config(fused_update=saved.fused_update, storage_dtype=saved.storage_dtype)
    return {k: (sum(o[k] for o in outs) / WORLD).numpy() for k in outs[0]}


def test_tau_round_with_batchnorm_state_matches_jax(tmp_path):
    saved = jget_config()
    jset_config(fused_update=False)
    try:
        fam = JFAMILIES["mobilenet"]
        js = JSolver(fam.solver(), fam.net(WORLD * B_LOCAL))
        snap = js.save(str(tmp_path / "start"))
        rs = np.random.RandomState(5)
        g = {"data": (rs.randn(TAU, WORLD * B_LOCAL, 3, 64, 64) * 40).astype(np.float32),
             "label": rs.randint(0, fam.num_classes, (TAU, WORLD * B_LOCAL)).astype(np.int32)}
        np.savez(tmp_path / "feeds.npz", **g)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        env = {k: v for k, v in env.items() if not k.startswith("JAX")}
        procs = [subprocess.Popen(
            [sys.executable, "-c", CHILD, str(r), str(WORLD), str(tmp_path),
             str(B_LOCAL), str(TAU)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
        jt = JTrainer(js, mesh=data_parallel_mesh(WORLD), tau=TAU)
        jloss = jt.train_round(lambda it: g)
        outs = [p.communicate(timeout=240) for p in procs]
        for p, (o, e) in zip(procs, outs):
            assert p.returncode == 0, f"worker failed:\n{o}\n{e}"
    finally:
        jset_config(fused_update=saved.fused_update)
    results = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]
    oracle = tau_oracle(snap, g)
    worst = (0.0, "-")
    for r, res in enumerate(results):
        np.testing.assert_allclose(float(res["loss"]), float(jloss), rtol=TAU_LOSS_RTOL)
        for ln, blobs in jt.variables.params.items():
            for i in range(len(blobs)):
                close(res[f"param/{ln}/{i}"], oracle[f"param/{ln}/{i}"],
                      f"rank {r} param {ln}[{i}] against the oracle")
                for j, h in enumerate(jt.slots[ln][i]):
                    err = rel_l2(res[f"hist/{ln}/{i}/{j}"], np.asarray(h)[r])
                    worst = max(worst, (err, f"rank {r} {ln}[{i}][{j}]"))
                    assert err <= TAU_HISTORY_REL_L2, f"rank {r} history {ln}[{i}][{j}]: {err:.3g}"
        assert len(jt.variables.state) == 27
        for ln, s in jt.variables.state.items():
            for k, v in s.items():
                close(res[f"state/{ln}/{k}"], np.asarray(v)[r], f"rank {r} state {ln}/{k}",
                      arel=TAU_STATE_AREL)
                close(res[f"state/{ln}/{k}"], oracle[f"state/{ln}/{k}"],
                      f"rank {r} state {ln}/{k} against the oracle")
    print(f"tau round against JAX: worst history relative L2 error {worst[0]:.3g} "
          f"({worst[1]})")
    # the round's average leaves the replicas' params and state equal
    a, b = results
    assert all(np.array_equal(a[k], b[k]) for k in a
               if k.startswith(("param/", "state/")))
