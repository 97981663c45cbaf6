"""The port's ``parallel`` layer: process-group set-up, placement rules, metrics, TP, BatchNorm, preemption.

On one process: ``init_distributed`` does nothing without a launch (and
``SLURM_NTASKS`` alone is no launch), the TP name rules are the JAX
module's, a placement without a mesh is the identity, and a metric's sync
changes nothing. Then real 2-rank gloo clusters on the CPU
(``tests/_torch_mp.py``), held to the port's one-process run, which the
other parity tests hold to JAX:

- the tiny UNet under ``param_sharding='tp'`` on a data 1 × model 2 mesh:
  3 train steps and a classify on the engine's own draws (global, so the
  same seed draws the same at world 1 and 2), parameters rtol 1e-5 / atol
  2e-6, predictions equal, and the attention and GEGLU weights really
  sliced in half;
- ResNet-18 (16 px, one channel) on the data axis: 2 train steps with the
  global batch's BatchNorm statistics, running averages within 1e-6 of
  world 1's; normalising by each rank's half-batch misses that; metric
  counters summed over the ranks once;
- SIGTERM to both ranks mid-epoch: both save at one agreed step, only rank
  0 writes, and the resumed run's losses are the uninterrupted run's,
  exactly.
"""

import select
import signal
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_mp as mp
from diffusion_classifier_tpu_torch.parallel import mesh as pmesh
from diffusion_classifier_tpu_torch.parallel.sharding import param_spec, shard_params
from diffusion_classifier_tpu_torch.utils.metrics import Accuracy

torch.set_num_threads(1)

_LAUNCH_VARS = (
    "RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID",
    "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK",
    "MASTER_ADDR", "MASTER_PORT",
)


@pytest.fixture
def no_launch(monkeypatch):
    for var in _LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_init_distributed_is_a_no_op_without_a_launch(no_launch):
    assert pmesh.init_distributed("cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    assert pmesh.make_mesh() is None
    assert pmesh.data_position() == (0, 1)
    assert pmesh.host_local_batch_size(8) == 8
    assert pmesh.is_main_process()


@pytest.mark.parametrize("env, want", [
    ({"SLURM_NTASKS": "4"}, None),  # inherited by a bare python inside salloc
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "2", "SLURM_LOCALID": "1"}, (2, 4, 1)),
    ({"SLURM_NTASKS": "1", "SLURM_PROCID": "0"}, None),
    ({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1"}, (1, 2, 0)),
    ({"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}, (0, 1, 0)),  # torchrun at world 1
])
def test_launch_proof_follows_the_jax_module(no_launch, env, want):
    for k, v in env.items():
        no_launch.setenv(k, v)
    assert pmesh._launch_env() == want


def test_a_launch_without_a_rendezvous_address_raises(no_launch):
    no_launch.setenv("SLURM_NTASKS", "2")
    no_launch.setenv("SLURM_PROCID", "1")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        pmesh.init_distributed("cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("name, shape, want", [
    ("backbone.down_1_attn_0.blocks.0.attn1.to_q.weight", (32, 32), "column"),
    ("backbone.mid_attn_0.blocks.0.attn2.to_v.weight", (32, 16), "column"),
    ("backbone.down_1_attn_0.blocks.0.ff.proj_in.weight", (256, 32), "column"),
    ("backbone.time_embedding.linear_1.weight", (64, 16), "column"),
    ("backbone.encoder_hid_proj.weight", (16, 16), "column"),
    ("backbone.down_1_attn_0.blocks.0.attn1.to_out.weight", (32, 32), "row"),
    ("backbone.down_1_attn_0.blocks.0.ff.proj_out.weight", (32, 128), "row"),
    ("backbone.time_embedding.linear_2.weight", (64, 64), "row"),
    ("backbone.down_1_attn_0.blocks.0.attn1.to_q.bias", (32,), None),  # 1-D: replicated
    ("backbone.down_1_attn_0.proj_in.weight", (32, 32, 1, 1), None),  # a 1x1 conv
    ("backbone.blocks.0.qkv.weight", (192, 64), None),  # the DiT's names match no rule
    ("backbone.blocks.0.mlp_fc1.weight", (256, 64), None),
])
def test_param_spec_follows_the_jax_name_rules(name, shape, want):
    assert param_spec(name, shape) == want


def test_placement_without_a_mesh_is_the_identity():
    module = torch.nn.Linear(3, 2)
    pl = shard_params(module, None, "fsdp")
    pl.wrap_for_training()
    assert pl.forward_module is module and pl.mesh is None
    g = torch.ones(2, 3)
    assert pl.grad_norm([g]) is None and pl.local(g) is g
    assert pl.full("weight", module.weight) is not None
    assert pl.mean_over_data(torch.tensor(2.0)) == 2.0
    with pytest.raises(ValueError):
        shard_params(module, None, "zero3")


def test_metric_sync_is_a_no_op_on_one_process():
    m = Accuracy("accuracy")
    m.update((np.array([1, 0, 1]), {"prompt": np.array([1, 1, 1])}))
    m.sync_across_processes()
    assert m.counters == {"correct": 2, "total": 3}


# ----------------------------------------------------------------- clusters
@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """The UNet (TP) and ResNet (data) clusters side by side; the one-process runs here meanwhile."""
    rng = np.random.default_rng(3)
    unet_in = dict(
        batches=[(rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32), rng.integers(0, 3, 4).astype(np.int32))
                 for _ in range(3)],
        classify_x=rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32),
        classify_y=rng.integers(0, 3, 4).astype(np.int32),
    )
    resnet_in = dict(batches=[
        (rng.uniform(-1, 1, (8, 16, 16, 1)).astype(np.float32), rng.integers(0, 3, 8).astype(np.int32))
        for _ in range(mp.RESNET_STEPS)
    ])
    started = {}
    try:
        for mode, inp in (("unet", unet_in), ("resnet", resnet_in)):
            workdir = tmp_path_factory.mktemp(mode)
            torch.save(inp, workdir / "inputs.pt")
            started[mode] = (workdir, mp.spawn(mode, workdir))
        unet = mp.unet_engine()
        losses, preds = mp.unet_run(unet, unet_in["batches"], unet_in["classify_x"], unet_in["classify_y"])
        unet_ref = dict(losses=losses, preds=preds, params=unet.state.model.state_dict(),
                        ema=unet.state.ema_model.state_dict())
        clf = mp.resnet_classifier()
        losses, init = mp.resnet_run(clf, resnet_in["batches"])
        resnet_ref = dict(losses=losses, init=init, state=clf.model.state_dict())
        outs = {mode: mp.collect(procs, workdir) for mode, (workdir, procs) in started.items()}
    finally:
        for _, procs in started.values():
            mp.finish(procs, timeout=1)
    return outs, {"unet": unet_ref, "resnet": resnet_ref}


def _close(got: dict, want: dict, names=None):
    for name in names or want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-5, atol=2e-6, err_msg=name)


def test_tp_unet_matches_one_process(clusters):
    outs, refs = clusters
    ref = refs["unet"]
    for out in outs["unet"]:  # both ranks of the model group hold every row
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-5)
        np.testing.assert_array_equal(out["preds"], ref["preds"])
        _close(out["params"], ref["params"])
        _close(out["ema"], ref["ema"])


def test_tp_slices_attention_and_geglu(clusters):
    outs, refs = clusters
    full = refs["unet"]["params"]
    prefix = "backbone.down_1_attn_0.blocks.0."
    for out in outs["unet"]:
        shapes = out["local_shapes"]
        assert shapes["to_q"] == (full[prefix + "attn1.to_q.weight"].shape[0] // 2,
                                  full[prefix + "attn1.to_q.weight"].shape[1])
        assert shapes["to_out"] == (full[prefix + "attn1.to_out.weight"].shape[0],
                                    full[prefix + "attn1.to_out.weight"].shape[1] // 2)
        assert shapes["proj_in"][0] == full[prefix + "ff.proj_in.weight"].shape[0] // 2
        assert shapes["proj_out"][1] == full[prefix + "ff.proj_out.weight"].shape[1] // 2
        assert out["tp_kinds"] == {"to_q": "column", "to_out": "row", "proj_in": "column", "proj_out": "row"}
        sliced = out["tp_slices"]
        assert sliced[prefix + "ff.proj_in.weight"] == (0, True)  # value and gate halves paired
        for name in (prefix + "attn1.to_k.weight", prefix + "attn1.to_v.weight",
                     prefix + "attn2.to_v.weight", "backbone.time_embedding.linear_1.weight",
                     "backbone.encoder_hid_proj.weight"):
            assert sliced[name] == (0, False), name
        assert sliced["backbone.time_embedding.linear_2.weight"] == (1, False)
        assert not any(".conv" in n or "norm" in n for n in sliced)


def test_global_batchnorm_matches_one_process(clusters):
    """Running statistics within 1e-6; parameters as ``test_torch_resnet.py`` holds them to JAX.

    Adam's step is about lr·sign(g), and a ReLU input within fp32 noise of
    0 may take the other side at the other world size: the head is held at
    rtol 1e-5 / atol 2e-6 and every other tensor's update at relative L2
    5e-2 (a fault in the gradient moves it by O(1)).
    """
    outs, refs = clusters
    ref = refs["resnet"]
    stats = [n for n in ref["state"] if "running" in n]
    assert stats
    for out in outs["resnet"]:
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-5)
        for name in stats:
            np.testing.assert_allclose(out["state"][name].numpy(), ref["state"][name].numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)
        for name, want in ref["state"].items():
            if name in stats:
                continue
            got = out["state"][name].numpy()
            if name.startswith("head."):
                np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=2e-6, err_msg=name)
            else:
                du, dw = got - ref["init"][name].numpy(), want.numpy() - ref["init"][name].numpy()
                assert np.linalg.norm(du - dw) <= 5e-2 * np.linalg.norm(dw), name


def test_per_rank_batchnorm_statistics_miss_the_tolerance(clusters):
    outs, refs = clusters
    ref = refs["resnet"]["state"]
    worst = max(
        float((out["local_stats_state"][n] - ref[n]).abs().max())
        for out in outs["resnet"] for n in out["local_stats_state"]
    )
    assert worst > 1e-4


def test_metric_sync_sums_over_the_data_group_once(clusters):
    outs, _ = clusters
    own = [out["own_counters"] for out in outs["resnet"]]
    assert own == [{"correct": 1, "total": 2}, {"correct": 1, "total": 3}]
    for out in outs["resnet"]:
        assert out["synced_counters"] == {"correct": 2, "total": 5}


def test_preemption_saves_at_one_step_and_resumes_exactly(tmp_path):
    procs = mp.spawn("preempt-train", tmp_path)
    try:
        deadline, seen = time.time() + 120, False
        while time.time() < deadline and not seen:
            ready, _, _ = select.select([procs[0].stdout], [], [], 5.0)
            line = procs[0].stdout.readline() if ready else ""
            if ready and not line:
                break  # rank 0 exited
            seen = line.startswith("step 5/")
        assert seen, "training never reached step 5"
        for p in procs:  # the orchestrator signals every rank
            p.send_signal(signal.SIGTERM)
        rcs, outs = mp.finish(procs, timeout=120)
    finally:
        mp.finish(procs, timeout=1)
    assert rcs == [128 + signal.SIGTERM] * 2, outs[0][-3000:] + outs[1][-3000:]
    assert "Preemption notice: saving checkpoint at synced step" in outs[0]
    logs = [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(2)]
    saved = logs[0]["saved_at"]
    assert len(saved) == 1 and logs[1]["saved_at"] == saved  # one agreed step
    step = saved[0]
    assert 5 <= step < mp.PREEMPT_STEPS
    assert [len(log["losses"]) for log in logs] == [step, step]
    assert logs[0]["writes"] and not logs[1]["writes"]  # rank 0 alone wrote

    resumed = mp.run_cluster("preempt-resume", tmp_path)
    for log, out in zip(logs, resumed):
        assert len(out["full_losses"]) == mp.PREEMPT_STEPS
        assert log["losses"] + out["losses"] == out["full_losses"]
