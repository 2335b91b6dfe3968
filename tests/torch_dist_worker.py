"""One rank of a multi-process run of the port on the CPU (gloo), for the
tests/test_torch_parallel*.py and tests/test_torch_eval.py modules. It
imports no JAX: the pytest process computes the JAX side and hands the
ranks their inputs in a spec file.

    python -m tests.torch_dist_worker <task> <spec.pt>

with ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` in the environment (set by
``spawn``). The spec carries the rendezvous URL (``file://`` in the test's
tmp_path) and the task's inputs; rank 0 writes the task's result to
``spec["out"]`` (every rank to ``spec["out"] + ".<rank>"`` where a task
reports per-rank facts).

Tasks:

- ``step``: from JAX parameters as numpy, shard over the (data, fsdp,
  tensor, pipe) mesh, run the train step on each step's batch of the rank's
  batch coordinate (tensor peers share it), and report the metrics, the
  whole trainable leaves after the steps, each frozen leaf's bytes on this
  rank, the all-gathers that made a vocabulary leaf whole in the steps,
  and optionally resume from / save a checkpoint and export; a run may
  plant a fault, bring its own parameters, loss config and vocabulary
  chunk, or run the validation step instead (``eval``);
- ``pipe``: jobs on meshes with pipeline stages, each on its own mesh in
  one process group: ``pipelined_decoder_hidden`` against given
  embeddings (and its gradients), or the ``step`` task's runs;
- ``serve``: ``ServingEngine(mesh=)`` runs (rank 0 submits, every rank
  reports the tokens its copies of the requests emitted) and
  ``UltravoxInference(mesh=)`` on a checkpoint directory, every rank
  calling ``infer`` with the same samples; each engine's vocabulary bytes
  and the all-gathers that made a vocabulary leaf whole;
- ``train``: ``training/train.py::main`` on the given argv, the model
  pack's parameters replaced by the given numpy tree when there is one;
- ``eval``: ``evaluation/eval.py::eval_datasets`` through
  ``UltravoxInference`` on a checkpoint directory.
"""

from __future__ import annotations

import math
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Ranks:
    """``world`` ranks of ``task`` started in the background (``start``);
    ``result()`` waits for them and returns rank 0's result with each
    rank's per-rank facts under "per_rank". Raises with every rank's
    output when one fails or the run outlasts ``timeout``."""

    def __init__(self, task: str, spec: dict, tmp_dir: str, world: int, timeout: float):
        os.makedirs(tmp_dir, exist_ok=True)
        self.task, self.world = task, world
        self.spec = dict(spec, init=f"file://{os.path.join(tmp_dir, 'rendezvous')}",
                         out=os.path.join(tmp_dir, "result.pt"))
        path = os.path.join(tmp_dir, "spec.pt")
        torch.save(self.spec, path)
        self.procs, self.logs = [], []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
            for k in ("MASTER_ADDR", "MASTER_PORT"):
                env.pop(k, None)
            log = open(os.path.join(tmp_dir, f"rank{rank}.log"), "w+")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_dist_worker", task, path], cwd=ROOT,
                env=env, stdout=log, stderr=subprocess.STDOUT))
        self.deadline = time.time() + timeout
        self._out = None

    def result(self) -> dict:
        if self._out is not None:
            return self._out
        try:
            for p in self.procs:
                p.wait(timeout=max(self.deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for log in self.logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
        if any(p.returncode != 0 for p in self.procs):
            raise RuntimeError(f"{self.task} at world {self.world}: return codes "
                               f"{[p.returncode for p in self.procs]}\n" + "\n".join(
                                   f"--- rank {r}\n{t[-4000:]}" for r, t in enumerate(texts)))
        out_path = self.spec["out"]
        out = torch.load(out_path, weights_only=False)
        out["per_rank"] = [torch.load(f"{out_path}.{r}", weights_only=False)
                           if os.path.exists(f"{out_path}.{r}") else None
                           for r in range(self.world)]
        self._out = out
        return out


def start(task: str, spec: dict, tmp_dir: str, world: int, timeout: float = 240) -> Ranks:
    """Start ``world`` ranks of ``task`` in the background."""
    return Ranks(task, spec, tmp_dir, world, timeout)


def spawn(task: str, spec: dict, tmp_dir: str, world: int, timeout: float = 240) -> dict:
    """Run ``task`` on ``world`` ranks and wait: rank 0's result."""
    return start(task, spec, tmp_dir, world, timeout).result()


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# the output shape of every all_gather_into_tensor this rank issued, in
# order (``main`` installs the spy)
GATHERED: list = []


def _spy_gathers():
    import torch.distributed as dist

    real = dist.all_gather_into_tensor

    def spy(out, inp, *args, **kwargs):
        GATHERED.append(tuple(out.shape))
        return real(out, inp, *args, **kwargs)

    dist.all_gather_into_tensor = spy


def _vocab_gathers(cfg, since: int) -> int:
    """The gathers since ``GATHERED[since]`` that made a vocabulary leaf
    whole over ``tensor``: either leaf's tensor gather gives (V, D)."""
    tc = cfg.text_config
    return sum(s == (tc.vocab_size, tc.hidden_size) for s in GATHERED[since:])


def _join(spec):
    from ultravox_torch.parallel.mesh import initialize_multihost

    initialize_multihost(spec["init"], int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                         device="cpu")


def task_step(spec, rank, world):
    """Each of ``spec["runs"]`` from the same initial parameters, one
    process group for all: {"batches": [[per-rank batch] a step], "accum",
    "fault", "resume", "save"}."""
    from ultravox_torch.parallel import mesh as pm

    _join(spec)
    mesh = pm.make_mesh(pm.MeshConfig(spec["data"], spec["fsdp"], spec.get("tensor", 1),
                                      spec.get("pipe", 1)))
    results, facts = _step_runs(spec, mesh, world)
    torch.save(facts, f"{spec['out']}.{rank}")
    if rank == 0:
        torch.save({"runs": results, "mesh": mesh.shape}, spec["out"])


def _step_runs(spec, mesh, world):
    """``spec["runs"]`` on ``mesh``: (rank 0's results, this rank's facts)."""
    from ultravox_torch.models import decoder
    from ultravox_torch.models import ultravox as uv
    from ultravox_torch.models.weights import from_jax_params
    from ultravox_torch.parallel import sharding
    from ultravox_torch.training import checkpoint as ckpt
    from ultravox_torch.training import train_step as ts

    cfg = spec["cfg"]
    pipe_mesh = mesh if mesh.shape["pipe"] > 1 else None
    global_count, proj_apply, reduce_gradients = uv._global, decoder.proj_apply, ts.reduce_gradients
    results, facts, splits, stages, vocab = [], [], [], [], []
    for run in spec["runs"]:
        params = sharding.shard_params(from_jax_params(run.get("params", spec["params"]), cfg),
                                       mesh, cfg=cfg)
        loss_config = run.get("loss_config", spec["loss_config"])
        vocab_chunk = run.get("vocab_chunk", spec.get("vocab_chunk"))
        opt = ts.make_optimizer(spec["lr"], **spec["opt"])
        if run.get("accum", 1) > 1:
            opt = ts.multi_steps(opt, run["accum"])
        state, template = ts.init_train_state(params, opt, spec["trainable"], device="cpu")
        facts.append({k: (v.untyped_storage().nbytes(), v.numel() * v.element_size(),
                          sharding.full_shape(v), sharding.shard_of(v) is not None)
                      for k, v in state.frozen.items()})
        splits.append({k: getattr(sharding.split_of(v), "dim", None)
                       for k, v in state.frozen.items()})
        stages.append({k: (getattr(sharding.stage_of(v), "offset", None), tuple(v.shape))
                       for k, v in {**state.trainable, **state.frozen}.items()})
        if run.get("resume"):
            state = ckpt.restore_checkpoint(run["resume"], state)
        if run.get("fault") == "mean_of_means":  # each rank's mean, averaged over the ranks
            uv._global = lambda count, group: count * world if group is not None else count
        if run.get("fault") == "no_o_proj_reduce":  # o_proj's partial sums never added
            o_rows = cfg.text_config.num_heads * cfg.text_config.head_dim // mesh.shape["tensor"]

            def faulty(x, p):
                sp = sharding.split_of(p.get("kernel"))
                if sp is not None and sp.dim == -2 and p["kernel"].shape[-2] == o_rows:
                    return x @ p["kernel"]
                return proj_apply(x, p)

            decoder.proj_apply = faulty
        if run.get("fault") == "pipe_p_times":  # a whole leaf's gradient counted on every stage
            def p_times(params, grads, mesh):
                out = reduce_gradients(params, grads, mesh)
                return [g * mesh.shape["pipe"] if sharding.stage_of(p) is None else g
                        for p, g in zip(params, out)]

            ts.reduce_gradients = p_times
        step = ts.make_train_step(cfg, loss_config, opt, template, remat=True,
                                  attn_impl="flash", vocab_chunk=vocab_chunk,
                                  pipe_mesh=pipe_mesh, pipe_micro=spec.get("pipe_micro"),
                                  mesh=mesh)
        metrics = []
        since = len(GATHERED)
        if run.get("eval"):  # the validation step's (sum, count), added over the batch axes
            eval_fn = ts.make_eval_step(cfg, loss_config, template,
                                        vocab_chunk=vocab_chunk, attn_impl="flash",
                                        pipe_mesh=pipe_mesh, pipe_micro=spec.get("pipe_micro"),
                                        mesh=mesh)
            for per_shard in run["batches"]:
                s, c = eval_fn(state, _tensors(per_shard[mesh.batch_index]))
                sums = sharding.all_reduce_(torch.stack([s.double(), c.double()]),
                                            mesh.batch_group)
                metrics.append({"nll_sum": float(sums[0]), "count": float(sums[1])})
            run = dict(run, batches=[])
        for per_shard in run["batches"]:  # one batch a batch coordinate
            state, m = step(state, _tensors(per_shard[mesh.batch_index]))
            metrics.append({k: float(v) for k, v in m.items()})
        vocab.append(_vocab_gathers(cfg, since))
        uv._global, decoder.proj_apply = global_count, proj_apply
        ts.reduce_gradients = reduce_gradients
        trainable = {k: sharding.gather_as(v, v).detach().clone()
                     for k, v in state.trainable.items()}
        if run.get("save"):
            if run.get("late") and mesh.rank != 0:  # the master writes before this rank looks
                time.sleep(1.0)
            ckpt.save_checkpoint(run["save"], state)
            ckpt.export_safetensors(state, os.path.join(run["save"], "model.safetensors"))
        results.append({"metrics": metrics, "trainable": trainable, "step": state.step})
    return results, {"held": facts, "split": splits, "stage": stages, "vocab_gathers": vocab,
                     "rows": (mesh.batch_index, mesh.batch_shards), "coords": mesh.coords}


def task_pipe(spec, rank, world):
    """Each of ``spec["jobs"]`` on its own mesh (``"mesh"``: data, fsdp,
    tensor, pipe), one process group for all: "hidden" runs
    ``pipelined_decoder_hidden`` (and its gradients), "step" the train
    step's runs as ``task_step`` does."""
    from ultravox_torch.parallel import mesh as pm

    _join(spec)
    results, facts = [], []
    for job in spec["jobs"]:
        mesh = pm.make_mesh(pm.MeshConfig(*job["mesh"]))
        if job["kind"] == "hidden":
            results.append(_pipe_hidden(job, mesh))
            facts.append(None)
        else:
            out, fact = _step_runs(job, mesh, world)
            results.append({"runs": out, "mesh": mesh.shape})
            facts.append(fact)
    torch.save(facts, f"{spec['out']}.{rank}")
    if rank == 0:
        torch.save({"jobs": results}, spec["out"])


def _pipe_hidden(job, mesh):
    """``pipelined_decoder_hidden`` on the job's decoder (JAX numpy tree)
    and embeddings: the last stage's hidden states and, with "grads", the
    gradients of mean(h^2) for every leaf (whole) and the embeddings,
    summed over the stages; a "fault" runs each stage's layers with
    stage-local indices."""
    from ultravox_torch.parallel import pipeline, sharding

    cfg = job["cfg"]
    lm = sharding.map_paths(lambda _, a: torch.from_numpy(a.copy()), job["params"])
    lm = sharding.shard_params({"language_model": lm}, mesh)["language_model"]
    leaves = dict(sharding.path_items(lm))
    for v in leaves.values():
        v.requires_grad_(job.get("grads", False))
    embeds = torch.from_numpy(job["embeds"]).requires_grad_(job.get("grads", False))
    first = pipeline._first_layer
    if job.get("fault") == "local_index":
        pipeline._first_layer = lambda mesh, n: 0
    try:
        h = pipeline.pipelined_decoder_hidden(
            lm, cfg, embeds, torch.from_numpy(job["positions"]), torch.from_numpy(job["valid"]),
            mesh=mesh, n_micro=job.get("n_micro"), remat=job.get("remat", False))
    finally:
        pipeline._first_layer = first
    last = mesh.stage == mesh.n_stages - 1
    group = mesh.groups["pipe"]
    out = {"hidden": sharding.all_reduce_(h.detach().clone() if last else torch.zeros_like(h),
                                          group)}
    if job.get("grads"):
        loss = (h.float() ** 2).mean() if last else h.float().sum() * 0
        names = list(leaves)
        grads = torch.autograd.grad(loss, [embeds] + [leaves[k] for k in names],
                                    allow_unused=True, materialize_grads=True)
        whole = {}
        for k, g in zip(names, grads[1:]):
            leaf = leaves[k]
            whole[k] = (sharding.gather_as(g, leaf) if sharding.is_placed(leaf)
                        else sharding.all_reduce_(g.clone(), group))
        out["loss"] = float(sharding.all_reduce_(loss.detach().clone(), group))
        out["grads"] = whole
        out["d_embeds"] = sharding.all_reduce_(grads[0].clone(), group)
    return out


def task_train(spec, rank, world):
    from ultravox_torch.models.weights import from_jax_params
    from ultravox_torch.training import train as ttrain

    if spec.get("params") is not None:
        make = ttrain.create_model_pack

        def pack(c):
            p = make(c)
            p.params = from_jax_params(spec["params"], p.config, device="cpu")
            return p

        ttrain.create_model_pack = pack
    sys.argv = ["train"] + spec["argv"] + [
        "--coordinator_address", spec["init"], "--num_processes", str(world),
        "--process_id", str(rank)]
    config = ttrain.get_train_config()
    metrics = ttrain.train(config)
    torch.save({"metrics": metrics}, f"{spec['out']}.{rank}")
    if rank == 0:
        torch.save({"metrics": metrics}, spec["out"])


def task_eval(spec, rank, world):
    """``eval_datasets`` through ``UltravoxInference`` on the checkpoint
    directory ``spec["model"]`` (fp32, the CPU), each rank's batch sizes
    recorded."""
    from ultravox_torch.evaluation.eval import eval_datasets
    from ultravox_torch.inference.ultravox_infer import UltravoxInference

    _join(spec)
    inference = UltravoxInference(spec["model"], dtype=torch.float32, max_cache_len=256,
                                  device="cpu")
    seen = []
    infer_batch = inference.infer_batch

    def spy(samples, *a, **kw):
        seen.append(len(samples))
        return infer_batch(samples, *a, **kw)

    inference.infer_batch = spy
    scores = eval_datasets(inference, spec["eval_config"])
    torch.save({"scores": scores, "batches": seen}, f"{spec['out']}.{rank}")
    if rank == 0:
        torch.save({"scores": scores}, spec["out"])


def _serving_run(run, params, cfg, mesh, rank):
    """One ServingEngine(mesh=): rank 0 submits every request and drains
    its stream; each rank reports the tokens and finish reason of its own
    copies, in request order, and its engine's counters."""
    from ultravox_torch.inference.serving.engine import ServingEngine

    eng = ServingEngine(params, cfg, mesh=mesh, device="cpu", cache_dtype=torch.float32,
                        **run["kw"])
    held = _vocab_bytes(eng.params)
    eng.start()
    try:
        if rank == 0:
            reqs = [eng.submit(dict(b), max_tokens=run["max_tokens"], lora=n)
                    for b, n in zip(run["batches"], run["names"])]
        out = []
        if rank == 0:
            for r in reqs:
                ids, finish = [], None
                for ev in eng.stream(r, timeout=120):
                    if ev.token_id is None:
                        finish = ev.finish_reason
                        break
                    ids.append(ev.token_id)
                out.append((ids, finish))
    finally:
        eng.stop()
    if rank != 0:
        for r in sorted(eng.mirrored, key=lambda r: r.request_id):
            ids, finish = [], None
            while True:
                ev = r.out_queue.get(timeout=10)
                if ev.token_id is None:
                    finish = ev.finish_reason
                    break
                ids.append(ev.token_id)
            out.append((ids, finish))
    return {"tokens": out, "spec_dispatches": eng.spec_dispatches, "vocab_bytes": held,
            "blocks": eng.stat_decode_steps > eng.stat_decode_dispatches}


def _vocab_bytes(params):
    """{path: (bytes held, the whole leaf's bytes)} of an engine's
    vocabulary leaves."""
    from ultravox_torch.parallel import sharding

    return {path: (leaf.untyped_storage().nbytes(),
                   math.prod(sharding.full_shape(leaf)) * leaf.element_size())
            for path, leaf in sharding.path_items(params)
            if re.fullmatch(sharding.VOCAB_LEAVES, path)}


def task_serve(spec, rank, world):
    """Each of ``spec["runs"]``: {"kw", "batches", "names", "max_tokens"}
    through ``ServingEngine(mesh=)`` on ``spec["params"]`` (JAX numpy),
    and ``spec["infer"]`` samples through ``UltravoxInference(mesh=)`` on
    ``spec["ckpt"]``; every rank reports."""
    from ultravox_torch.data.sample import VoiceSample
    from ultravox_torch.inference.ultravox_infer import UltravoxInference
    from ultravox_torch.models.weights import from_jax_params
    from ultravox_torch.parallel import mesh as pm

    _join(spec)
    mesh = pm.make_mesh(pm.MeshConfig(1, spec.get("fsdp", 1), spec["tensor"]))
    cfg = spec["cfg"]
    since = len(GATHERED)
    runs = []
    for run in spec["runs"]:
        params = from_jax_params(spec["params"], cfg)
        if run.get("adapters"):
            run = dict(run, kw=dict(run["kw"], lora_adapters={
                k: from_jax_params(v, cfg) for k, v in run["adapters"].items()}))
        runs.append(_serving_run(run, params, cfg, mesh, rank))
    infer = []
    if spec.get("infer"):
        infer_since = len(GATHERED)  # the constructor places the tree: count it too
        inf = UltravoxInference(spec["ckpt"], dtype=torch.float32, max_cache_len=256,
                                device="cpu", mesh=mesh)
        infer_bytes = _vocab_bytes(inf.engine.params)
        for text, audio in spec["infer"]:
            sample = (VoiceSample.from_prompt(text) if audio is None
                      else VoiceSample.from_prompt_and_audio(text, audio, 16000))
            o = inf.infer(sample, max_tokens=spec["max_tokens"])
            infer.append((o.text, o.input_tokens, o.output_tokens))
        infer_gathers = _vocab_gathers(inf.cfg, infer_since)
    facts = {"runs": runs, "infer": infer, "vocab_gathers": _vocab_gathers(cfg, since)}
    if spec.get("infer"):
        facts.update(infer_bytes=infer_bytes, infer_vocab_gathers=infer_gathers)
    torch.save(facts, f"{spec['out']}.{rank}")
    if rank == 0:
        torch.save({"runs": runs, "infer": infer}, spec["out"])


def main():
    task, path = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    spec = torch.load(path, weights_only=False)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    _spy_gathers()
    {"step": task_step, "train": task_train, "eval": task_eval,
     "serve": task_serve, "pipe": task_pipe}[task](spec, rank, world)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
