"""The vlm, encoder-decoder and hybrid families' sharded steps on a
(data, model) mesh of four CPU ranks, against the reference's sharded
step on four forced host devices.

As tests/test_torch_spmd.py does for the dense, moe and ssm families, two
programs run once for the whole file, side by side, each in its own
process (this file, run as a script with ``--role``):

* **reference**: ``JAX_PLATFORMS=cpu`` with four forced host devices; for
  the reduced float32 llava-next-34b, seamless-m4t-large-v2 and
  hymba-1.5b, the reference's train step jitted with
  ``in_shardings``/``out_shardings`` as its dry run states them
  (``src/repro/launch/dryrun.py:122-141``) on ``jax.make_mesh`` with
  ``Auto`` axes: 2×2 for each, and 1×4 for hymba (2 kv heads under a
  ``model`` of 4). Three AdamW steps (lr 1e-3, weight decay 0.1) and the
  gradients of the first batch, on batches of 4 × 32 tokens, with
  llava's 16 frontend embeddings before them and seamless's 64 frames
  (two encoder windows of 32) beside them.
* **port**: four gloo ranks (``torch.multiprocessing.spawn``), from the
  same weights (``params_from_reference``) and batches (NumPy, seeded):
  ``make_train_step(..., mesh=)`` on the same meshes and the plain step
  (no mesh); then ``make_prefill_step`` and three ``make_decode_step``
  steps on the mesh route (K3 per rank in ``local_map``, its plain
  version on CPU tensors; hymba's Mamba scan per rank) against the route
  without a mesh, fed the same tokens: llava's prompt after its
  frontend embeddings, seamless's 64 frames encoded and its (k, v),
  hymba's prompt of 80 over its window of 64 (the ring buffer wraps), on
  2×2, on 1×4, and on 4×1 at batch 2, where the batch does not divide
  ``data`` and the Mamba state's d goes over it (as ``long_500k``'s batch
  of 1 places it on 16×16).

Limits, as tests/test_torch_spmd.py's: losses within ``LOSS_RTOL`` (1e-5)
relative; parameters after one and three steps by ρ = |p_port − p_ref| /
|p_ref − p0| ≤ ``STEP_RHO`` (0.05) a tensor; first-step gradients within
``GRAD_TOL`` (1e-5) of each tensor's largest; the mesh route's logits,
caches and seamless's (k, v) within ``LOGIT_TOL`` (1e-5) of the largest.
None is wider than the reference's. A gradient of hymba's ``A`` left
replicated over the batch split (tools/plant_faults.py
``hybrid_scan_A_grad_not_partial``) reads O(1) on ``logA``.
"""
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

from test_torch_spmd import (LOGIT_TOL, LOSS_RTOL, STEP_RHO, _wait, flatten,
                             rho, save, unflatten)

ARCHS = ("llava-next-34b", "seamless-m4t-large-v2", "hymba-1.5b")
TRAIN_MESHES = {"llava-next-34b": ((2, 2),),
                "seamless-m4t-large-v2": ((2, 2),),
                "hymba-1.5b": ((2, 2), (1, 4))}
TRAIN_CASES = [(a, m) for a in ARCHS for m in TRAIN_MESHES[a]]
# (arch, mesh, batch) of the inference cases
INFER_CASES = (("llava-next-34b", (2, 2), 4),
               ("seamless-m4t-large-v2", (2, 2), 4),
               ("hymba-1.5b", (2, 2), 4), ("hymba-1.5b", (1, 4), 4),
               ("hymba-1.5b", (4, 1), 2))
B, S, STEPS, LR, WD = 4, 32, 3, 1e-3, 0.1
FRAMES = 64            # seamless: two windows of its reduced encoder's 32
HYMBA_PROMPT = 80      # over hymba's reduced window of 64
GRAD_TOL = 1e-5
DECODE_STEPS = 3
TIMEOUT = 600


def tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def case_id(case):
    arch, mesh, batch = case
    return f"{arch}-{tag(mesh)}-b{batch}"


def batches(cfg, n=STEPS, seed=7):
    """Training batches of ``cfg`` (either package's reduced config):
    tokens and labels, and a vlm's frontend embeddings or an
    encoder-decoder's frames."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        n_fe = FRAMES if cfg.encoder_layers else cfg.n_frontend_embeds
        if n_fe:
            b["frontend_embeds"] = rng.standard_normal(
                (B, n_fe, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


# ---------------------------------------------------------------------------
# the reference: the sharded train step on four forced host devices


def run_reference(out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

    from repro.configs import get_config
    from repro.launch.steps import make_train_step
    from repro.optim import adamw
    from repro.sharding import batch_specs, param_specs, tree_shardings

    assert len(jax.devices()) == 4, jax.devices()
    built = {}
    for arch in ARCHS:  # the weights first: the port waits for them
        cfg = get_config(arch, reduced=True)
        model, opt, step = make_train_step(
            cfg, optimizer=adamw(LR, weight_decay=WD), remat=False)
        params = model.init(jax.random.PRNGKey(0))
        save(f"{out}/init_{arch}.npz",
             flatten(jax.tree_util.tree_map(np.asarray, params)))
        built[arch] = (cfg, model, opt, step, params)
    for arch, mesh_shape in TRAIN_CASES:
        cfg, model, opt, step, params = built[arch]
        # GSPMD's propagation (``Auto`` axes), as the reference was written
        # for (tests/test_torch_spmd.py)
        mesh = jax.make_mesh(mesh_shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        opt_state = opt.init(params)
        bs = [{k: jnp.asarray(v) for k, v in b.items()}
              for b in batches(cfg)]
        pspec = param_specs(params, mesh)
        ospec = param_specs(opt_state, mesh)
        bspec = batch_specs(bs[0], mesh)
        jitted = jax.jit(step,
                         in_shardings=(tree_shardings(pspec, mesh),
                                       tree_shardings(ospec, mesh),
                                       tree_shardings(bspec, mesh)),
                         out_shardings=(tree_shardings(pspec, mesh),
                                        tree_shardings(ospec, mesh),
                                        NamedSharding(mesh, P())))
        grad_fn = jax.jit(jax.value_and_grad(model.loss),
                          in_shardings=(tree_shardings(pspec, mesh),
                                        tree_shardings(bspec, mesh)),
                          out_shardings=(NamedSharding(mesh, P()),
                                         tree_shardings(pspec, mesh)))
        res, p = {}, params
        with mesh:
            _, grads = grad_fn(p, bs[0])
            res.update({f"grad/{k}": v for k, v in flatten(
                jax.tree_util.tree_map(np.asarray, grads)).items()})
            for i, b in enumerate(bs):
                p, opt_state, loss = jitted(p, opt_state, b)
                res[f"loss/{i}"] = np.asarray(loss)
                if i in (0, STEPS - 1):
                    res.update({f"p{i + 1}/{k}": v for k, v in flatten(
                        jax.tree_util.tree_map(np.asarray, p)).items()})
        save(f"{out}/ref_{arch}_{tag(mesh_shape)}.npz", res)


# ---------------------------------------------------------------------------
# the port: four gloo ranks


def _port_rank(rank, world, port, out):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        _port_checks(rank, out)
    finally:
        dist.destroy_process_group()


def _port_checks(rank, out):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import params_from_reference
    from repro_torch.optim import Optimizer, adamw
    from repro_torch.sharding import step_placements

    grads_only = Optimizer(init=lambda p: {}, update=lambda g, s, p: (g, s),
                           name="grads")
    res, info = {}, {}
    meshes = {shape: make_mesh(shape, ("data", "model"), "cpu")
              for shape in ((2, 2), (1, 4), (4, 1))}
    p0_of = {}
    t_phase = time.perf_counter()
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        p0 = p0_of[arch] = params_from_reference(
            unflatten(_wait(f"{out}/init_{arch}.npz")))
        bs = [{k: torch.from_numpy(v) for k, v in b.items()}
              for b in batches(cfg)]
        _, opt, plain = steps.make_train_step(cfg, adamw(LR, weight_decay=WD),
                                              remat=True, device="cpu")
        p, s = dict(p0), opt.init(p0)
        for i, b in enumerate(bs):
            p, s, loss = plain(p, s, b)
            res[f"{arch}/1x1/loss/{i}"] = loss.numpy()
            if i in (0, STEPS - 1):
                res.update({f"{arch}/1x1/p{i + 1}/{n}": t.numpy()
                            for n, t in p.items()})
        for shape in TRAIN_MESHES[arch]:
            mesh, key = meshes[shape], f"{arch}/{tag(shape)}"
            # remat (per block checkpoints of DTensors, the Mamba scan's
            # local_map inside) in one case
            remat = (arch, shape) == ("hymba-1.5b", (2, 2))
            _, opt, step = steps.make_train_step(
                cfg, adamw(LR, weight_decay=WD), remat=remat, device="cpu",
                mesh=mesh)
            pl, ol, bpl = step_placements("train", mesh, params=p0,
                                          opt_state=opt.init(p0),
                                          batch=bs[0])["in"]
            p = train.distribute(dict(p0), pl, mesh)
            s = train.distribute(opt.init(p0), ol, mesh)
            t = time.perf_counter()
            for i, b in enumerate(bs):
                p, s, loss = step(p, s, train.distribute(b, bpl, mesh))
                res[f"{key}/loss/{i}"] = loss.full_tensor().numpy()
                if i in (0, STEPS - 1):
                    res.update({f"{key}/p{i + 1}/{n}": v.numpy()
                                for n, v in train.gather(p).items()})
            info[f"{key}/step_s"] = (time.perf_counter() - t) / STEPS
            info[f"{key}/loss_placements"] = str(loss.placements)
            _, _, gstep = steps.make_train_step(cfg, grads_only, remat=True,
                                                device="cpu", mesh=mesh)
            g, _, _ = gstep(train.distribute(dict(p0), pl, mesh), {},
                            train.distribute(bs[0], bpl, mesh))
            res.update({f"{key}/grad/{n}": v.numpy()
                        for n, v in train.gather(g).items()})
    info["train_s"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    for case in INFER_CASES:
        _inference(res, info, case, meshes[case[1]], p0_of[case[0]])
    info["inference_s"] = time.perf_counter() - t_phase
    info["scan_refusal"] = _scan_refusal(meshes[(2, 2)])
    if rank == 0:
        save(f"{out}/port.npz", res)
        with open(f"{out}/port.json", "w") as f:
            json.dump(info, f)


def _leaves(tree):
    """The tensors of a cache or of (k, v), in order, whole copies (a
    decode step writes its cache in place)."""
    if isinstance(tree, tuple):
        return [t for part in tree for t in _leaves(part)]
    # a replicated DTensor's full_tensor() is its local tensor itself
    whole = tree.full_tensor() if hasattr(tree, "full_tensor") else tree
    return [whole.clone()]


def _inference(res, info, case, mesh, p0):
    """Prefill, then ``DECODE_STEPS`` greedy steps, without a mesh and on
    the mesh route, both fed the route without a mesh's tokens; records
    the logits, the caches after prefill and after the last step (and
    seamless's (k, v)), and K3's ``_on_mesh`` calls in the mesh route's
    prefill."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps, train
    from repro_torch.sharding import step_placements

    arch, shape, batch = case
    cfg = get_config(arch, reduced=True)
    rng = np.random.default_rng(11)
    prompt = HYMBA_PROMPT if cfg.hybrid else S
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt)))
    n_fe = FRAMES if cfg.encoder_layers else cfg.n_frontend_embeds
    fe = torch.from_numpy(rng.standard_normal(
        (batch, n_fe, cfg.d_model)).astype(np.float32)) if n_fe else None
    k3_calls = []
    run = fa._on_mesh

    def counted(*a):
        k3_calls.append(1)
        return run(*a)

    fa._on_mesh = counted
    fed, name = [], case_id(case)
    try:
        for on_mesh in (False, True):
            m = mesh if on_mesh else None
            model, prefill = steps.make_prefill_step(cfg, "prefill_32k",
                                                     device="cpu", mesh=m)
            dmodel, decode = steps.make_decode_step(cfg, "decode_32k",
                                                    device="cpu", mesh=m)
            model.load_state_dict(p0)
            dmodel.load_state_dict(p0)
            if on_mesh:
                steps.distribute_model(model, mesh)
                steps.distribute_model(dmodel, mesh)

            def put(t, kind="tokens"):
                if not on_mesh or t is None:
                    return t
                at = 2 if kind == "frontend_embeds" else 1
                return train.distribute(t, step_placements(
                    "prefill", mesh, **{kind: t})["in"][at], mesh)

            k3_calls.clear()
            if cfg.encoder_layers:
                enc_kv = prefill(put(fe, "frames"))
                cache = dmodel.init_cache(batch, 8)
                if on_mesh:
                    cache = steps.place_cache(cache, mesh)
                extra, first = (enc_kv,), _leaves(enc_kv)
                logits = None
            else:
                logits, cache = prefill(put(tokens), prompt + n_fe
                                        + DECODE_STEPS, frontend_embeds=put(
                                            fe, "frontend_embeds"))
                extra, first = (), _leaves(cache)
            if on_mesh:
                info[f"k3_on_mesh/{name}"] = len(k3_calls)
            got = [] if logits is None else _leaves(logits)
            if not on_mesh:
                fed.append(torch.zeros((batch, 1), dtype=torch.long)
                           if logits is None
                           else torch.argmax(got[-1][:, -1], -1)[:, None])
            for i in range(DECODE_STEPS):
                logits, cache = decode(cache, put(fed[i]), *extra)
                got += _leaves(logits)
                if not on_mesh:
                    fed.append(torch.argmax(got[-1][:, -1], -1)[:, None])
            route = "mesh" if on_mesh else "plain"
            for j, t in enumerate(got):
                res[f"infer/{name}/logits/{j}/{route}"] = t.numpy()
            for j, t in enumerate(first + _leaves(cache)):
                if t.is_floating_point():
                    res[f"infer/{name}/cache/{j}/{route}"] = t.numpy()
    finally:
        fa._on_mesh = run


def _scan_refusal(mesh):
    """The Mamba scan on the 2×2 mesh with x sharded over its sequence:
    it must raise, naming the placement."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.ssm import selective_scan_on_mesh

    def placed(shape, *placements):
        return distribute_tensor(torch.zeros(shape), mesh, placements,
                                 src_data_rank=None)

    x = placed((B, S, 8), Replicate(), Shard(1))
    bc = placed((B, S, 4), Replicate(), Replicate())
    try:
        selective_scan_on_mesh(x, x, bc, bc, torch.zeros(8, 4),
                               torch.zeros(B, 8, 4))
    except ValueError as e:
        return str(e)
    return None


def run_port(out):
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_port_rank, args=(4, port, out), nprocs=4)


# ---------------------------------------------------------------------------
# the tests


def start(out, root=Path(__file__).resolve().parents[1]):
    """Both programs, started together in the checkout at ``root``, with
    their results to go to ``out``: {role: process}."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(Path(root) / "src"), str(Path(root) / "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    script = str(Path(root) / "tests" / Path(__file__).name)
    return {role: subprocess.Popen(
        [sys.executable, script, "--role", role, "--out", out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for role in ("reference", "port")}


@pytest.fixture(scope="module")
def runs():
    """Start both programs together and wait for both."""
    out = tempfile.mkdtemp(prefix="spmd_families_")
    procs = start(out)
    logs = {role: p.communicate(timeout=TIMEOUT)[0]
            for role, p in procs.items()}
    for role, p in procs.items():
        assert p.returncode == 0, f"{role} failed:\n{logs[role][-6000:]}"
    return load(out)


def load(out):
    """The two programs' results in ``out``."""
    with open(f"{out}/port.json") as f:
        info = json.load(f)
    return {"ref": {(a, m): dict(np.load(f"{out}/ref_{a}_{tag(m)}.npz"))
                    for a, m in TRAIN_CASES},
            "port": dict(np.load(f"{out}/port.npz")), "info": info,
            "init": {a: dict(np.load(f"{out}/init_{a}.npz")) for a in ARCHS}}


def _ref_as_port(flat):
    from repro_torch.models.convert import params_from_reference
    return {n: t.numpy() for n, t in
            params_from_reference(unflatten(flat)).items()}


def _sub(tree, prefix):
    return {k[len(prefix):]: v for k, v in tree.items()
            if k.startswith(prefix)}


def _rel(a, b):
    """max |a - b| over max |b|."""
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) or 1.0)


def readings(runs) -> dict:
    """Every comparison of the file over its limit (a reading <= 1
    passes; NaN fails), keyed as the tests read them:
    ``ref/<arch>/<mesh>/loss``, ``…/p1`` and ``…/p3`` (ρ), ``…/grad``;
    ``one/<arch>/<mesh>/loss`` and ``…/params`` against the port's step
    without a mesh; ``infer/<case>/logits`` and ``…/cache``."""
    port, out = runs["port"], {}
    for arch, mesh in TRAIN_CASES:
        ref = runs["ref"][arch, mesh]
        p0 = _ref_as_port(runs["init"][arch])
        key = f"{arch}/{tag(mesh)}"
        out[f"ref/{key}/loss"] = float(np.max([
            abs(float(port[f"{key}/loss/{i}"]) - float(ref[f"loss/{i}"]))
            / abs(float(ref[f"loss/{i}"])) for i in range(STEPS)])) / LOSS_RTOL
        for after in (1, STEPS):
            want = _ref_as_port(_sub(ref, f"p{after}/"))
            got = _sub(port, f"{key}/p{after}/")
            assert got.keys() == want.keys()
            out[f"ref/{key}/p{after}"] = rho(got, want, p0)[0] / STEP_RHO
        want = _ref_as_port(_sub(ref, "grad/"))
        got = _sub(port, f"{key}/grad/")
        assert got.keys() == want.keys()
        out[f"ref/{key}/grad"] = float(np.max([
            _rel(got[n], want[n]) for n in want])) / GRAD_TOL
        out[f"one/{key}/loss"] = float(np.max([
            abs(float(port[f"{key}/loss/{i}"])
                - float(port[f"{arch}/1x1/loss/{i}"]))
            / abs(float(port[f"{arch}/1x1/loss/{i}"]))
            for i in range(STEPS)])) / LOSS_RTOL
        out[f"one/{key}/params"] = float(np.max([
            rho(_sub(port, f"{key}/p{a}/"), _sub(port, f"{arch}/1x1/p{a}/"),
                p0)[0] for a in (1, STEPS)])) / STEP_RHO
    for case in INFER_CASES:
        name = case_id(case)
        for part in ("logits", "cache"):
            plain = _sub(port, f"infer/{name}/{part}/")
            errs = []
            for k in (k for k in plain if k.endswith("/plain")):
                a, b = plain[k], plain[k[:-len("plain")] + "mesh"]
                assert a.shape == b.shape, (name, k)
                errs.append(_rel(b, a))
            assert errs, (name, part)
            out[f"infer/{name}/{part}"] = float(np.max(errs)) / LOGIT_TOL
    return out


def _passes(reading):
    return reading <= 1.0  # NaN fails


@pytest.fixture(scope="module")
def read(runs):
    return readings(runs)


@pytest.mark.parametrize("arch,mesh", TRAIN_CASES,
                         ids=[f"{a}-{tag(m)}" for a, m in TRAIN_CASES])
def test_sharded_loss_matches_reference(runs, read, arch, mesh):
    key = f"ref/{arch}/{tag(mesh)}/loss"
    assert _passes(read[key]), read[key]
    assert runs["info"][f"{arch}/{tag(mesh)}/loss_placements"] == \
        "(Replicate(), Replicate())"


@pytest.mark.parametrize("after", (1, STEPS))
@pytest.mark.parametrize("arch,mesh", TRAIN_CASES,
                         ids=[f"{a}-{tag(m)}" for a, m in TRAIN_CASES])
def test_sharded_params_match_reference(read, arch, mesh, after):
    key = f"ref/{arch}/{tag(mesh)}/p{after}"
    assert _passes(read[key]), read[key]


@pytest.mark.parametrize("arch,mesh", TRAIN_CASES,
                         ids=[f"{a}-{tag(m)}" for a, m in TRAIN_CASES])
def test_sharded_grads_match_reference(read, arch, mesh):
    key = f"ref/{arch}/{tag(mesh)}/grad"
    assert _passes(read[key]), read[key]


@pytest.mark.parametrize("arch,mesh", TRAIN_CASES,
                         ids=[f"{a}-{tag(m)}" for a, m in TRAIN_CASES])
def test_meshes_match_one_device(read, arch, mesh):
    """Each mesh's step against the port's own step without a mesh."""
    for part in ("loss", "params"):
        key = f"one/{arch}/{tag(mesh)}/{part}"
        assert _passes(read[key]), (key, read[key])


@pytest.mark.parametrize("case", INFER_CASES, ids=case_id)
def test_mesh_route_prefill_and_decode(runs, read, case):
    """Logits of the prefill and of each decode step, and every float
    tensor of the caches (and seamless's (k, v)), mesh route against the
    route without a mesh."""
    name = case_id(case)
    for k, v in runs["port"].items():
        if k.startswith(f"infer/{name}/") and k.endswith("/mesh"):
            assert np.all(np.isfinite(v)), k
    for part in ("logits", "cache"):
        key = f"infer/{name}/{part}"
        assert _passes(read[key]), (key, read[key])


@pytest.mark.parametrize("case", INFER_CASES, ids=case_id)
def test_k3_runs_per_rank_in_mesh_prefill(runs, case):
    """K3's placement checks (``_on_mesh``) ran once a layer of the mesh
    route's prefill: the decoder's layers, or seamless's encoder's."""
    from repro_torch.configs import get_config
    cfg = get_config(case[0], reduced=True)
    want = cfg.encoder_layers or cfg.n_layers
    assert runs["info"][f"k3_on_mesh/{case_id(case)}"] == want


def test_scan_refuses_a_sharded_sequence(runs):
    msg = runs["info"]["scan_refusal"]
    assert msg and "selective_scan" in msg and "Shard(dim=1)" in msg, msg


def test_encdec_steps_honour_the_mesh():
    """An encoder-decoder's prefill and decode steps given ``mesh=`` (a
    1×1 gloo mesh of one process) return DTensors: (k, v) placed for
    decode, the logits replicated; without a mesh, plain tensors equal to
    them."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train

    cfg = get_config("seamless-m4t-large-v2", reduced=True)
    frames = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, FRAMES, cfg.d_model)).astype(np.float32))
    tokens = torch.zeros((2, 1), dtype=torch.long)
    mesh = train.fit_mesh("cpu")
    try:
        out = {}
        for m in (None, mesh):
            model, prefill = steps.make_prefill_step(cfg, "prefill_32k",
                                                     device="cpu", mesh=m)
            model.init(torch.Generator("cpu").manual_seed(0))
            dmodel, decode = steps.make_decode_step(cfg, "decode_32k",
                                                    device="cpu", mesh=m)
            dmodel.load_state_dict(model.state_dict())
            if m is not None:
                steps.distribute_model(model, m)
                steps.distribute_model(dmodel, m)
            enc_kv = prefill(frames)
            cache = dmodel.init_cache(2, 4)
            if m is not None:
                cache = steps.place_cache(cache, m)
            logits, _ = decode(cache, tokens, enc_kv)
            out[m is not None] = (enc_kv, logits)
    finally:
        dist.destroy_process_group()
    (kv0, l0), (kv1, l1) = out[False], out[True]
    assert not isinstance(l0, DTensor) and not isinstance(kv0[0], DTensor)
    assert all(isinstance(t, DTensor) for t in (*kv1, l1))
    assert l1.placements == (Replicate(), Replicate())
    torch.testing.assert_close(l1.full_tensor(), l0, rtol=1e-5, atol=1e-5)
    for a, b in zip(kv1, kv0):
        torch.testing.assert_close(a.full_tensor(), b, rtol=1e-5, atol=1e-5)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", choices=("reference", "port"), required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    (run_reference if a.role == "reference" else run_port)(a.out)
