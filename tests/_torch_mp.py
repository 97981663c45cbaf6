"""Multi-process clusters for the port's tests: the launcher, the models and the rank workers.

As a module (the tests import it): :func:`spawn` starts a ``world``-rank
gloo cluster on the CPU, one ``python tests/_torch_mp.py <mode> <workdir>``
per rank, with torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` on a free local port), so
each worker joins through ``parallel.mesh.init_distributed``.
:func:`run_cluster` waits for all of them with a timeout. The parent
writes the inputs to ``<workdir>/inputs.pt``; rank ``r`` writes
``<workdir>/out<r>.pt``.

As a script it is one rank. It imports torch and the port only (never
jax): the parent makes any JAX draws and writes each request with its
answer, and the worker replays them in order (:class:`Replay`).

Modes: ``dit`` (train, evaluate, and under ``fsdp`` the clip and
checkpoints across placements), ``unet`` (tensor parallel, data 1 ×
model 2), ``resnet`` (global BatchNorm statistics), ``preempt-train`` /
``preempt-resume`` (the agreed-step save and the resume), and ``dit-cuda``
(DDP over gloo with CUDA tensors, both ranks on one card: the GPU tests).
"""

import os
import signal
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# 2 layers, 2 heads x 32, 32 px at patch 4 (64 tokens): the DiT of
# test_torch_train's JAX reference run
TINY_DIT = dict(
    num_attention_heads=2, attention_head_dim=32, in_channels=4, num_layers=2,
    sample_size=32, patch_size=4, num_classes=3,
)
DIT_CONFIG = dict(
    pred_param="v", schedule="shifted_cosine", noise_d=64, image_size=32, image_channels=4,
    classes=3, encoder_type="DiT", mixed_precision="no", learning_rate=1e-3,
    lr_warmup_steps=2, ema_beta=0.9999, ema_warmup=1, ema_update_freq=1, n_stages=2,
    evaluation_per_stage=(2, 4), n_keep_per_stage=(2, 1), batch_size=4, seed=0,
    use_comet=False, progress=False,
)
TRAIN_STEPS = 3

# __graft_entry__.py's tiny flagship UNet (8 px, levels 16/32, 2 heads at
# the cross-attention level): every TP unit divides by a model axis of 2
TINY_UNET = dict(
    sample_size=8, in_channels=3, out_channels=3, block_out_channels=(16, 32),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"), layers_per_block=1,
    attention_head_dim=2, cross_attention_dim=16, encoder_hid_dim=16,
    encoder_hid_dim_type="text_proj", norm_num_groups=8,
)
UNET_CONFIG = dict(
    pred_param="v", schedule="cosine", noise_d=8, image_size=8, image_channels=3, classes=3,
    encoder_type="nn", mixed_precision="no", learning_rate=1e-3, lr_warmup_steps=1,
    ema_warmup=0, ema_update_freq=1, n_stages=1, evaluation_per_stage=(2,),
    n_keep_per_stage=(1,), batch_size=4, seed=1, use_comet=False, progress=False,
)

# the first step's learning rate is 0 under the warmup, so the second step's
# loss and BatchNorm statistics come from the same parameters at both world sizes
RESNET_CONFIG = dict(
    classes=3, image_size=16, image_channels=1, learning_rate=1e-3, lr_warmup_steps=1,
    batch_size=8, seed=2, use_comet=False, variant="resnet18",
)
RESNET_STEPS = 2

# 8 px at patch 4: 4 tokens a 2-layer DiT, so a CPU step takes milliseconds
PREEMPT_DIT = dict(TINY_DIT, sample_size=8)
PREEMPT_CONFIG = dict(
    DIT_CONFIG, image_size=8, noise_d=8, num_epochs=1, save_image_epochs=1,
    evaluation_batches=0, log_every_steps=1, experiment_dir="run",
)
PREEMPT_STEPS = 60  # one epoch: the signal arrives in it, so the order is the restart's


# ------------------------------------------------------------------ launcher
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(mode: str, workdir, world: int = 2):
    """Start the ranks of ``mode`` (stdout piped, stderr folded in); returns the ``Popen`` list."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONUNBUFFERED="1", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), mode, str(workdir)],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    return procs


def finish(procs, timeout: float = 240):
    """Wait for every rank (killing all at the deadline); returns ``(returncodes, outputs)``."""
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def collect(procs, workdir, timeout: float = 240) -> list:
    """Wait for a cluster that must exit 0; returns each rank's ``out<r>.pt``."""
    rcs, outs = finish(procs, timeout)
    for rank, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {rank} exited {rc}:\n{out[-4000:]}"
    return [torch.load(os.path.join(workdir, f"out{r}.pt"), weights_only=False) for r in range(len(procs))]


def run_cluster(mode: str, workdir, world: int = 2, timeout: float = 240) -> list:
    """Run ``mode`` on ``world`` ranks to the end; returns each rank's ``out<r>.pt``."""
    return collect(spawn(mode, workdir, world), workdir, timeout)


# ------------------------------------------------------------------- draws
class Replay:
    """Answers the recorded requests in order; a request that differs from the record raises."""

    def __init__(self, records):
        self.records, self.i = list(records), 0

    def _next(self, name, args):
        want_name, want_args, out = self.records[self.i]
        self.i += 1
        if (want_name, tuple(want_args)) != (name, tuple(args)):
            raise AssertionError(f"draw {self.i}: asked {name}{args}, recorded {want_name}{want_args}")
        return out

    def loss(self, *args):
        return self._next("loss", args)

    def noise(self, *args):
        return self._next("noise", args)

    def fast_select(self, *args):
        return self._next("fast_select", args)


# ------------------------------------------------------------------- models
def dit_engine(tmp, param_sharding="replicated", seed=0, mesh=None, device="cpu", **overrides):
    from diffusion_classifier_tpu_torch.engine import DiffusionClassifier
    from diffusion_classifier_tpu_torch.models.dit import DiT, DiTConfig
    from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(**dict(
        DIT_CONFIG, project_root=str(tmp), experiment_dir="exp", seed=seed,
        param_sharding=param_sharding, **overrides,
    ))
    return DiffusionClassifier(DiT(DiTConfig(**TINY_DIT)), cfg, device=device, mesh=mesh)


def load_weights(engine, state_dict, steps=TRAIN_STEPS):
    """Whole denoiser weights into the placed model and its EMA, then a fresh train state."""
    engine.init_params()
    engine.state.placement.load(state_dict)
    engine.state.ema_placement.load(state_dict)
    engine._build_train_state(steps)


def rows(batch_x, batch_y, engine):
    pl = engine.state.placement
    b = batch_x.shape[0] // pl.data_count
    sl = slice(pl.data_index * b, (pl.data_index + 1) * b)
    return {"images": batch_x[sl], "prompt": batch_y[sl]}


def train(engine, batches, records, first=0, last=TRAIN_STEPS):
    return [
        float(engine.train_step(rows(x, y, engine), draws=Replay(records[i])))
        for i, (x, y) in enumerate(batches) if first <= i < last
    ]


def full_state(engine):
    """The training parameters and the EMA, gathered whole (a collective)."""
    st = engine.state
    return st.placement.full_state_dict(), st.ema_placement.full_state_dict()


def evaluate(engine, val_x, val_y, records):
    """Classify the val set through ``evaluate`` with replayed draws; ``(predictions, synced counters)``."""
    from diffusion_classifier_tpu_torch.data.loader import ArrayDataLoader
    from diffusion_classifier_tpu_torch.utils.metrics import F1, Accuracy

    batches = iter(records)
    classify = engine.classify
    engine.classify = lambda x, labels: classify(x, labels, draws=Replay(next(batches)))
    loader = ArrayDataLoader(val_x, val_y, DIT_CONFIG["batch_size"], shuffle=False)
    metrics = [Accuracy("accuracy"), F1("f1")]
    preds, _, metrics = engine.evaluate(loader, metrics=metrics, classification=True)
    for m in metrics:
        m.sync_across_processes(engine._data_group)
    del engine.classify
    return [p.numpy() for p in preds], {m.name: dict(m.counters) for m in metrics}


def unet_engine(mesh=None):
    from diffusion_classifier_tpu_torch.engine import DiffusionClassifier
    from diffusion_classifier_tpu_torch.models.unet import UNetCondition2D, UNetConfig
    from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(**dict(UNET_CONFIG, param_sharding="tp"))
    return DiffusionClassifier(UNetCondition2D(UNetConfig(**TINY_UNET)), cfg, device="cpu", mesh=mesh)


def unet_run(engine, batches, classify_x, classify_y):
    """3 train steps and a classify on the engine's own draws; ``(losses, predictions)``."""
    engine.init_params()
    engine._build_train_state(len(batches))
    losses = [float(engine.train_step(rows(x, y, engine))) for x, y in batches]
    part = rows(classify_x, classify_y, engine)
    return losses, engine.classify(part["images"], part["prompt"]).numpy()


def resnet_classifier(mesh=None):
    from diffusion_classifier_tpu_torch.engine.classifier import Classifier
    from diffusion_classifier_tpu_torch.models.resnet import ResNet2D
    from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(**RESNET_CONFIG)
    return Classifier(ResNet2D("resnet18", in_channels=1), cfg, device="cpu", mesh=mesh)


def resnet_run(clf, batches):
    """2 train steps; returns ``(losses, the whole state before them)``."""
    clf.init_params()
    clf._build_train_step(len(batches))
    init = {k: v.clone() for k, v in clf.placement.full_state_dict().items()}
    out = []
    for x, y in batches:
        pl = clf.placement
        b = x.shape[0] // pl.data_count
        sl = slice(pl.data_index * b, (pl.data_index + 1) * b)
        out.append(float(clf.train_step({"images": x[sl], "prompt": y[sl]})))
    return out, init


def preempt_engine(root, **overrides):
    from diffusion_classifier_tpu_torch.data.synthetic import SyntheticDataLoader
    from diffusion_classifier_tpu_torch.engine import DiffusionClassifier
    from diffusion_classifier_tpu_torch.models.dit import DiT, DiTConfig
    from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(**dict(PREEMPT_CONFIG, project_root=str(root), **overrides))
    engine = DiffusionClassifier(DiT(DiTConfig(**PREEMPT_DIT)), cfg, device="cpu")
    data = SyntheticDataLoader(
        PREEMPT_STEPS * cfg.batch_size, cfg.batch_size, batch_size=cfg.batch_size,
        image_size=8, channels=4, classes=3, seed=0,
    )
    return engine, data


def recorded_train_loop(engine, data, log):
    """``train_loop`` with each step's global loss and each save's step appended to ``log``."""
    step = engine.train_step
    save = engine.save_checkpoint

    def train_step(batch, **kw):
        loss = step(batch, **kw)
        log["losses"].append(float(loss))
        return loss

    def save_checkpoint(*args, **kw):
        log["saved_at"].append(engine.state.step)
        return save(*args, **kw)

    engine.train_step, engine.save_checkpoint = train_step, save_checkpoint
    engine.train_loop(data.get_train_loader(), data.get_val_loader())


# ------------------------------------------------------------------ workers
def _count_writes(log):
    save = torch.save

    def counted(obj, f, *args, **kw):
        log.append(str(f))
        return save(obj, f, *args, **kw)

    torch.save = counted
    return save


def _dit(workdir, rank, world):
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    mode = inp["param_sharding"]
    out = {}
    engine = dit_engine(workdir, mode, gradient_accumulation_steps=inp["accum"])
    load_weights(engine, inp["weights"])
    pl = engine.state.placement
    out["placed"] = {
        "fsdp": pl.fsdp, "ddp": pl._ddp is not None,
        "dtensors": sum(type(p).__name__ == "DTensor" for p in engine.state.model.parameters()),
        "ema_dtensors": sum(type(p).__name__ == "DTensor" for p in engine.state.ema_model.parameters()),
    }
    writes = []
    if mode == "fsdp":
        out["losses"] = train(engine, inp["batches"], inp["train_draws"], last=2)
        real_save = _count_writes(writes)
        engine.save_checkpoint(0)  # the state after 2 steps, written at world 2 under FSDP
        torch.save = real_save
        out["losses"] += train(engine, inp["batches"], inp["train_draws"], first=2)
    else:
        out["losses"] = train(engine, inp["batches"], inp["train_draws"])
    out["params"], out["ema"] = full_state(engine)
    out["preds"], out["counters"] = evaluate(engine, inp["val_x"], inp["val_y"], inp["val_draws"])
    out["writes"] = writes
    if mode == "fsdp":
        # resume the FSDP checkpoint at FSDP: step 3 as the uninterrupted run's
        resumed = dit_engine(workdir, mode, seed=9, gradient_accumulation_steps=inp["accum"])
        load_weights(resumed, inp["weights"])
        resumed.load_checkpoint(os.path.join(workdir, "exp", "checkpoints"))
        out["resumed_losses"] = train(resumed, inp["batches"], inp["train_draws"], first=2)
        out["resumed_params"], _ = full_state(resumed)
        # the one-process checkpoint at FSDP: whole state as written, then step 3
        other = dit_engine(workdir, mode, seed=9, gradient_accumulation_steps=inp["accum"])
        load_weights(other, inp["weights"])
        other.load_checkpoint(inp["w1_checkpoint"])
        st = other.state
        named = list(st.model.named_parameters())
        out["w1_loaded"] = {
            "params": st.placement.full_state_dict(), "ema": st.ema_placement.full_state_dict(),
            "mu": [st.placement.full(n, m, like=p) for (n, p), m in zip(named, st.opt_state.mu)],
            "nu": [st.placement.full(n, m, like=p) for (n, p), m in zip(named, st.opt_state.nu)],
            "counters": (st.step, st.ema_counter, st.opt_state.count),
        }
        out["w1_resumed_losses"] = train(other, inp["batches"], inp["train_draws"], first=2)
        out["w1_resumed_params"], _ = full_state(other)
        out["clip"] = clip_run(dit_engine(workdir, mode), inp)
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))


def clip_run(engine, inp):
    """‖g‖ and the clipped gradients of a scaled loss, whole; at world 1 too (the parent calls it).

    ``inp["clip_draws"]`` holds the global ``(u, t, ε)``; each rank takes its rows.
    """
    load_weights(engine, inp["weights"])
    st, pl = engine.state, engine.state.placement
    x, y = inp["batches"][0]
    part = rows(x, y, engine)
    b = part["images"].shape[0]
    sl = slice(pl.data_index * b, (pl.data_index + 1) * b)
    u, t, eps = (d[sl] for d in inp["clip_draws"])
    loss = engine._loss_fn(engine._images(part["images"]), engine._labels(part["prompt"]), u, t, eps)
    (loss * inp["clip_scale"]).backward()
    named = list(st.model.named_parameters())
    grads = [pl.local(p.grad) for _, p in named]
    norm = pl.grad_norm(grads)
    if norm is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    from diffusion_classifier_tpu_torch.engine.state import make_optimizer

    tx = make_optimizer(1e-3, 0, 1)
    tx.update(grads, tx.init(st.params()), st.params(), global_norm=pl.grad_norm)
    return float(norm), {n: pl.full(n, g, like=p) for (n, p), g in zip(named, grads)}


def _unet(workdir, rank, world):
    from diffusion_classifier_tpu_torch.parallel.mesh import make_mesh

    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    engine = unet_engine(make_mesh(1, 2, device_type="cpu"))
    losses, preds = unet_run(engine, inp["batches"], inp["classify_x"], inp["classify_y"])
    st = engine.state
    attn = engine.denoiser.backbone.down_1_attn_0.blocks[0]
    out = {
        "losses": losses, "preds": preds,
        "params": st.placement.full_state_dict(), "ema": st.ema_placement.full_state_dict(),
        "tp_slices": dict(st.placement.tp_slices),
        "local_shapes": {
            "to_q": tuple(attn.attn1.to_q.weight.shape), "to_out": tuple(attn.attn1.to_out.weight.shape),
            "proj_in": tuple(attn.ff.proj_in.weight.shape), "proj_out": tuple(attn.ff.proj_out.weight.shape),
        },
        "tp_kinds": {n: getattr(m.tp, "kind", None) for n, m in (
            ("to_q", attn.attn1.to_q), ("to_out", attn.attn1.to_out),
            ("proj_in", attn.ff.proj_in), ("proj_out", attn.ff.proj_out))},
    }
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))


def _resnet(workdir, rank, world):
    from diffusion_classifier_tpu_torch.models.resnet import BatchNorm

    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    clf = resnet_classifier()
    losses, _ = resnet_run(clf, inp["batches"])
    out = {"losses": losses, "state": clf.placement.full_state_dict()}
    # the fault this guards: each rank normalising by its own half-batch
    local = resnet_classifier()
    local.init_params()
    for m in local.model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = None
    local._build_train_step(len(inp["batches"]))
    for x, y in inp["batches"]:
        b = x.shape[0] // world
        local.train_step({"images": x[rank * b:(rank + 1) * b], "prompt": y[rank * b:(rank + 1) * b]})
    out["local_stats_state"] = {k: v for k, v in local.model.state_dict().items() if "running" in k}
    # counters summed over the data group, once however often sync is called
    from diffusion_classifier_tpu_torch.utils.metrics import Accuracy

    metric = Accuracy("accuracy")
    metric.update((np.arange(rank + 2) % 2, {"prompt": np.ones(rank + 2, np.int64)}))
    out["own_counters"] = dict(metric.counters)
    metric.sync_across_processes(clf.placement.data_group)
    metric.sync_across_processes(clf.placement.data_group)
    out["synced_counters"] = dict(metric.counters)
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))


def _dit_cuda(workdir, rank, world):
    """DDP over gloo with both ranks' CUDA tensors on one card: 3 steps on the engine's own draws."""
    from diffusion_classifier_tpu_torch.ops import flash_attention as fa

    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    engine = dit_engine(workdir, "replicated", device="cuda:0")
    engine.init_params()
    engine._build_train_state(TRAIN_STEPS)
    losses = [float(engine.train_step(rows(x, y, engine))) for x, y in inp["batches"]]
    params, _ = full_state(engine)
    torch.save({"losses": losses, "params": {k: v.cpu() for k, v in params.items()},
                "launches": (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches),
                "ddp": engine.state.placement._ddp is not None},
               os.path.join(workdir, f"out{rank}.pt"))


def _preempt(workdir, rank, world, phase):
    log = {"losses": [], "saved_at": [], "writes": []}
    real_save = _count_writes(log["writes"])
    try:
        if phase == "train":
            engine, data = preempt_engine(workdir)
            recorded_train_loop(engine, data, log)
        else:
            engine, data = preempt_engine(workdir, resume=True)
            recorded_train_loop(engine, data, log)
            full = {"losses": [], "saved_at": [], "writes": []}
            engine, data = preempt_engine(workdir, experiment_dir="full")
            recorded_train_loop(engine, data, full)
            log["full_losses"] = full["losses"]
    finally:
        torch.save = real_save
        torch.save(log, os.path.join(workdir, f"out{rank}.pt"))


def main():
    mode, workdir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    from diffusion_classifier_tpu_torch.parallel.mesh import init_distributed

    init_distributed(device="cuda:0" if mode.endswith("-cuda") else "cpu", backend="gloo")
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    if mode == "dit":
        _dit(workdir, rank, world)
    elif mode == "dit-cuda":
        _dit_cuda(workdir, rank, world)
    elif mode == "unet":
        _unet(workdir, rank, world)
    elif mode == "resnet":
        _resnet(workdir, rank, world)
    elif mode.startswith("preempt-"):
        _preempt(workdir, rank, world, mode.split("-", 1)[1])
    else:
        raise SystemExit(f"unknown mode {mode}")
    dist.destroy_process_group()


if __name__ == "__main__":
    signal.signal(signal.SIGINT, signal.default_int_handler)
    main()
