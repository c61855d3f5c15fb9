"""One rank of tests/test_torch_parallel.py's process group.

    python tests/torch_parallel_worker.py <dir> <rank> <world>

Joins a gloo group through a file store under <dir>, runs every case named
in <dir>/job.pt on the inputs there, and writes what each case returns to
<dir>/out<rank>.pt ({case: result, or the error's text}). It imports the
port and torch only (no JAX), and runs on one CPU thread.
"""

import os
import sys
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from resolution_pde_tpu_torch.deploy import ServingEngine  # noqa: E402
from resolution_pde_tpu_torch.models.cno import CNO2d  # noqa: E402
from resolution_pde_tpu_torch.models.ffno import FFNO1D, FFNO2D  # noqa: E402
from resolution_pde_tpu_torch.models.fno import FNO1d, FNO2d  # noqa: E402
from resolution_pde_tpu_torch.models.mgpt import MoEGPTNO  # noqa: E402
from resolution_pde_tpu_torch.models.norms import sync_batch_stats  # noqa: E402
from resolution_pde_tpu_torch.ops.losses import relative_l2  # noqa: E402
from resolution_pde_tpu_torch.ops.normalizers import (  # noqa: E402
    SimpleNormalizer, UnitGaussianNormalizer)
from resolution_pde_tpu_torch.parallel import (  # noqa: E402
    data_axis_size, ffno_tp_specs, fsdp_specs, make_mesh,
    make_multislice_mesh, merge_specs, moe_ep_specs, pipeline_apply,
    shard_batch, shard_module, shard_train_state, sharded,
    stack_stage_params)
from resolution_pde_tpu_torch.parallel.collectives import gather_tensor  # noqa: E402
from resolution_pde_tpu_torch.parallel.mesh import (  # noqa: E402
    axis_rank, data_rank)
from resolution_pde_tpu_torch.parallel.shard import (  # noqa: E402
    full_state_dict, grad_sq_norm, plan, reduce_gradients)
from resolution_pde_tpu_torch.train import Trainer  # noqa: E402
from resolution_pde_tpu_torch.train.checkpoint import (  # noqa: E402
    restore_checkpoint, save_checkpoint)

FFNO2D_SMALL = dict(in_channels=1, out_channels=1, width=8, n_layers=2,
                    n_modes=8, ff_weight_norm=True, n_ff_layers=3,
                    layer_norm=True)
FFNO2D_FSDP = dict(in_channels=1, out_channels=1, width=16, n_layers=2,
                   n_modes=8, ff_weight_norm=True, n_ff_layers=2)
FFNO1D_SMALL = dict(in_channels=1, out_channels=1, width=8, n_layers=1,
                    n_modes=4)
CNO_SMALL = dict(N_layers=2, N_res=1, N_res_neck=1, channel_multiplier=4)
# JAX's tests/test_spatial_sharding.py models
SPATIAL_FFNO = dict(in_channels=1, out_channels=1, width=8, n_layers=2,
                    n_modes=8)
FNO2D_SMALL = dict(in_channels=1, out_channels=1, modes1=6, modes2=6,
                   width=8, n_blocks=1)
FNO1D_SMALL = dict(in_channels=1, out_channels=1, modes=4, width=8,
                   n_blocks=1)
SPATIAL_MESHES = {"data2_spatial2": {"data": 2, "spatial": 2},
                  "spatial4": {"spatial": 4}}
SPECTRAL_IMPLS = ("fft", "pallas", "pallas2")
MGPT_SMALL = dict(trunk_size=2, branch_size=2, space_dim=2, output_size=3,
                  n_layers=2, n_hidden=16, n_experts=4,
                  expert_impl="stacked")


def _model(cls, kw, sd):
    model = cls(**kw)
    model.load_state_dict(sd)
    return model


def _cno(sd):
    model = CNO2d(1, 1, 32, **CNO_SMALL)
    model.load_state_dict(sd)
    return model


def _steps(trainer, x, y, n):
    state = trainer.init()
    losses = []
    for _ in range(n):
        state, loss = trainer.train_step(state, x, y)
        losses.append(float(loss))
    return state, losses


def _error(fn):
    try:
        fn()
    except Exception as e:  # the message is the result
        return f"{type(e).__name__}: {e}"
    return None


def case_mesh(job, tmp):
    world = dist.get_world_size()
    out = {"default": dict(zip(make_mesh().mesh_dim_names,
                               make_mesh().mesh.shape))}
    m = make_mesh({"data": 2, "model": -1})
    out["inferred"] = dict(zip(m.mesh_dim_names, m.mesh.shape))
    out["two_unknown"] = _error(lambda: make_mesh({"data": -1, "model": -1}))
    out["wrong_size"] = _error(lambda: make_mesh({"data": world + 1}))
    out["indivisible"] = _error(lambda: make_mesh({"data": 3, "model": -1}))
    return out


def case_shard_batch(job, tmp):
    mesh = make_mesh()
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    t = torch.arange(16.0).reshape(8, 2)
    (xl,), w = shard_batch((x,), mesh)
    (tl,), tw = shard_batch((t,), mesh)
    (xr,), rw = shard_batch((x,), mesh, straggler="replicate")
    return {"pad_rows": xl, "pad_weights": w, "even_rows": tl,
            "even_weights": tw, "replicate_rows": xr,
            "replicate_weights": rw,
            "bad_mode": _error(lambda: shard_batch((x,), mesh, "drop"))}


def case_straggler(job, tmp):
    x, y, sd = job["straggler"]
    tr = Trainer(_model(FFNO1D, FFNO1D_SMALL, sd), learning_rate=1e-3,
                 device="cpu", mesh=make_mesh())
    state, losses = _steps(tr, x, y, 1)
    return {"losses": losses, "params": full_state_dict(state.model)}


def case_dp(job, tmp):
    x, y, sd = job["ffno2d"]
    tr = Trainer(_model(FFNO2D, FFNO2D_SMALL, sd), learning_rate=1e-3,
                 device="cpu")  # mesh=None in a process group: make_mesh()
    state, losses = _steps(tr, x, y, 3)
    return {"losses": losses, "params": full_state_dict(state.model),
            "mesh": dict(zip(tr.mesh.mesh_dim_names, tr.mesh.mesh.shape)),
            "eval": tr.evaluate(state, [(x, y), (x[:5], y[:5])])}


def case_bn(job, tmp):
    x, y, sd = job["cno2d"]
    mesh = make_mesh()
    model = _cno(sd)
    (xl,), _ = shard_batch((x,), mesh)
    model.train()
    with sync_batch_stats(model, mesh.get_group("data")):
        out = model(torch.as_tensor(xl))
    out = gather_tensor(out.detach(), mesh.get_group("data"))
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
    # an indivisible batch: every rank takes it whole (straggler replicate)
    tr = Trainer(_cno(sd), learning_rate=1e-3, device="cpu", mesh=mesh)
    state = tr.init()
    state, loss = tr.train_epoch(state, [(x[:5], y[:5])])
    return {"train_out": out, "stats": stats, "straggler_loss": loss,
            "straggler_state": full_state_dict(state.model)}


def case_fsdp(job, tmp):
    x, y, sd = job["ffno2d_fsdp"]
    mesh = make_mesh({"data": 4})
    model = _model(FFNO2D, FFNO2D_FSDP, sd)
    specs = fsdp_specs(model, mesh, min_size=1024)
    tr = Trainer(model, learning_rate=1e-3, device="cpu", mesh=mesh,
                 param_specs=specs)
    local = {k: tuple(v.to_local().shape) for k, v in
             model.named_parameters() if k in plan(model)}
    local.update({k: tuple(v.shape) for k, v in model.named_parameters()
                  if k not in plan(model)})
    # a layer's spectral weight: whole inside its layer's forward, the
    # shard again by the next layer's
    layers = model.fourier_layers
    seen = {}

    def shape_at(where):
        def hook(module, args):
            w = layers[0].fourier_weight[0]
            seen[where] = (type(w).__name__, tuple(
                w.to_local().shape if hasattr(w, "to_local") else w.shape))
        return hook

    hooks = [layers[0].backcast_ff.register_forward_pre_hook(
                 shape_at("inside")),
             layers[1].register_forward_pre_hook(shape_at("after"))]
    state, losses = _steps(tr, x, y, 3)
    for h in hooks:
        h.remove()
    full = {k: v.clone() for k, v in full_state_dict(state.model).items()}
    path = os.path.join(tmp, "fsdp_ckpt")
    save_checkpoint(path, state)
    dist.barrier()
    # a fresh sharded trainer restores the whole state and slices it
    tr2 = Trainer(_model(FFNO2D, FFNO2D_FSDP, sd), learning_rate=1e-3,
                  device="cpu", mesh=mesh, param_specs=specs)
    state2 = restore_checkpoint(path, tr2.init())[0]
    state2, loss4 = tr2.train_step(state2, x, y)
    state, loss4_ref = tr.train_step(state, x, y)
    return {"specs": specs, "local": local, "losses": losses,
            "params": full, "plan": sorted(plan(model)), "seen": seen,
            "resumed_loss": float(loss4), "continued_loss": float(loss4_ref)}


def case_tp(job, tmp):
    x, y, sd = job["ffno2d"]
    mesh = make_mesh({"data": 2, "model": 2})
    model = _model(FFNO2D, FFNO2D_SMALL, sd)
    specs = ffno_tp_specs(model, mesh)
    tr = Trainer(model, learning_rate=1e-3, device="cpu", mesh=mesh,
                 param_specs=specs)
    local = {k: tuple(v.shape) for k, v in model.named_parameters()}
    state, losses = _steps(tr, x, y, 3)
    # one step whole, then shard_train_state slices the model and the
    # moments, and the next step is the sharded run's second
    late = Trainer(_model(FFNO2D, FFNO2D_SMALL, sd), learning_rate=1e-3,
                   device="cpu", mesh=mesh)
    lstate, first = late.train_step(late.init(), x, y)
    lstate = shard_train_state(lstate, mesh, specs)
    lstate, second = late.train_step(lstate, x, y)
    return {"specs": specs, "local": local, "losses": losses,
            "params": full_state_dict(state.model),
            "late_losses": [float(first), float(second)],
            "late_w0": tuple(lstate.model.fourier_layers[0].backcast_ff
                             .layers[0][0].weight.shape)}


def case_tp_fsdp(job, tmp):
    x, y, sd = job["ffno2d_fsdp"]
    mesh = make_mesh({"data": 2, "model": 2})
    model = _model(FFNO2D, FFNO2D_FSDP, sd)
    specs = merge_specs(ffno_tp_specs(model, mesh),
                        fsdp_specs(model, mesh, min_size=1024))
    tr = Trainer(model, learning_rate=1e-3, device="cpu", mesh=mesh,
                 param_specs=specs)
    state, losses = _steps(tr, x, y, 3)
    return {"losses": losses, "params": full_state_dict(state.model),
            "axes": sorted({a for s in specs.values() for a in s
                            if a is not None})}


def case_clip(job, tmp):
    """grad_clip over TP and FSDP shards: the global norm."""
    x, y, sd = job["ffno2d_fsdp"]
    mesh = make_mesh({"data": 2, "model": 2})
    model = _model(FFNO2D, FFNO2D_FSDP, sd)
    specs = merge_specs(ffno_tp_specs(model, mesh),
                        fsdp_specs(model, mesh, min_size=1024))
    tr = Trainer(model, learning_rate=1e-3, device="cpu", mesh=mesh,
                 param_specs=specs, grad_clip=job["clip"])
    state, losses = _steps(tr, x, y, 2)
    # the gradients left by the last step: clipped to the global norm
    clipped = float(grad_sq_norm(model.parameters(), mesh).sqrt())
    free = Trainer(_model(FFNO2D, FFNO2D_FSDP, sd), learning_rate=1e-3,
                   device="cpu", mesh=mesh, param_specs=specs)
    fstate, _ = _steps(free, x, y, 1)
    return {"losses": losses, "params": full_state_dict(state.model),
            "clipped_norm": clipped,
            "norm": float(grad_sq_norm(fstate.model.parameters(),
                                       mesh).sqrt())}


def case_accum(job, tmp):
    """accum_steps 2 on the straggler batch: each rank's 2 rows in 2
    microbatches."""
    x, y, sd = job["straggler"]
    tr = Trainer(_model(FFNO1D, FFNO1D_SMALL, sd), learning_rate=1e-3,
                 device="cpu", mesh=make_mesh(), accum_steps=2)
    state, losses = _steps(tr, x, y, 1)
    return {"losses": losses, "params": full_state_dict(state.model)}


def case_fused_conflict(job, tmp):
    mesh = make_mesh({"data": 2, "model": 2})
    model = FFNO2D(**FFNO2D_SMALL, dropout=0.0, ff_impl="fused")
    return {"error": _error(lambda: Trainer(
        model, device="cpu", mesh=mesh,
        param_specs=ffno_tp_specs(model, mesh)))}


def case_ep(job, tmp):
    (g, u, pos), sd = job["mgpt"]
    mesh = make_mesh({"data": 2, "expert": 2})
    model = _model(MoEGPTNO, MGPT_SMALL, sd)
    specs = moe_ep_specs(model, mesh)
    shard_module(model, mesh, specs)
    with torch.no_grad():
        out = model(torch.as_tensor(g), torch.as_tensor(u),
                    torch.as_tensor(pos))
    return {"specs": specs, "out": out,
            "w1": tuple(model.blocks[0].moe1.w1.shape)}


def _sharded_grads(model, mesh, x, y):
    """The model on this rank's slabs of (x, y): its output slab and the
    gradients of the global batch's mean relative L2, reduced over the
    mesh as the trainer reduces them."""
    (xl, yl), _ = shard_batch((torch.as_tensor(x), torch.as_tensor(y)),
                              mesh, spatial_axis=2)
    with sharded(mesh):
        out = model(xl)
        (relative_l2(out, yl) / data_axis_size(mesh)).backward()
    reduce_gradients(model.parameters(), mesh)
    return {"out": out.detach(), "coords": (data_rank(mesh),
                                            axis_rank(mesh, "spatial")),
            "grads": {k: p.grad.clone() for k, p in
                      model.named_parameters()}}


def case_spatial(job, tmp):
    """FFNO2D on each spectral route and FNO2d on the slabs of both
    meshes: outputs and reduced gradients."""
    x, y, sds = job["spatial"]
    out = {}
    for name, axes in SPATIAL_MESHES.items():
        mesh = make_mesh(axes)
        for impl in SPECTRAL_IMPLS:
            model = _model(FFNO2D, dict(SPATIAL_FFNO, spectral_impl=impl),
                           sds["ffno2d"])
            out[name, impl] = _sharded_grads(model, mesh, x, y)
        out[name, "fno2d"] = _sharded_grads(
            _model(FNO2d, FNO2D_SMALL, sds["fno2d"]), mesh, x, y)
    return out


def case_spatial_train(job, tmp):
    """3 Trainer steps on data 2 x spatial 2; 2 with a per-location
    y-normalizer; a model that does not shard spatially refused."""
    x, y, sd = job["ffno2d"]
    mesh = make_mesh({"data": 2, "spatial": 2})
    tr = Trainer(_model(FFNO2D, FFNO2D_SMALL, sd), learning_rate=1e-3,
                 device="cpu", mesh=mesh)
    state, losses = _steps(tr, x, y, 3)
    params = {k: v.clone() for k, v in full_state_dict(state.model).items()}
    yn = UnitGaussianNormalizer.fit(torch.as_tensor(y))
    ntr = Trainer(_model(FFNO2D, FFNO2D_SMALL, sd), learning_rate=1e-3,
                  device="cpu", mesh=mesh, use_normalizer=True,
                  y_normalizer=yn)
    nstate, nlosses = _steps(ntr, x, y, 2)
    return {"losses": losses, "params": params, "norm_losses": nlosses,
            "norm_params": full_state_dict(nstate.model),
            "refused": _error(lambda: Trainer(
                FFNO1D(**FFNO1D_SMALL), device="cpu", mesh=mesh))}


def case_multislice(job, tmp):
    """make_multislice_mesh's axes, rules and rows; a train step on dcn 2
    x data 2 and on dcn 2 x spatial 2."""
    m = make_multislice_mesh(2, {"data": 2})
    (rows,), _ = shard_batch((torch.arange(16.0).reshape(8, 2),), m)

    def shape(mesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    out = {"shape": shape(m), "ranks": m.mesh.tolist(), "rows": rows,
           "default": shape(make_multislice_mesh(2)),
           "inferred": shape(make_multislice_mesh(2, {"data": -1})),
           "slices": _error(lambda: make_multislice_mesh(3)),
           "inner": _error(lambda: make_multislice_mesh(2, {"data": 4})),
           "dcn": _error(lambda: make_multislice_mesh(2, {"dcn": 2}))}
    x1, y1, sd1 = job["fno1d"]
    tr = Trainer(_model(FNO1d, FNO1D_SMALL, sd1), learning_rate=1e-3,
                 device="cpu", mesh=m)
    state, out["losses"] = _steps(tr, x1, y1, 1)
    out["params"] = full_state_dict(state.model)
    x, y, sd = job["ffno2d"]
    ms = make_multislice_mesh(2, {"spatial": 2})
    tr2 = Trainer(_model(FFNO2D, FFNO2D_SMALL, sd), learning_rate=1e-3,
                  device="cpu", mesh=ms)
    state2, out["dcn_spatial_losses"] = _steps(tr2, x, y, 1)
    out["dcn_spatial_shape"] = shape(ms)
    out["dcn_spatial_params"] = full_state_dict(state2.model)
    return out


def _engine(sd, mesh=None):
    return ServingEngine(_model(FFNO2D, FFNO2D_SMALL, sd),
                         x_normalizer=SimpleNormalizer(0.1, 1.5),
                         y_normalizer=SimpleNormalizer(-0.2, 0.8),
                         device="cpu", mesh=mesh)


def case_serve(job, tmp):
    """ServingEngine over data 4: predict (and a padded request) and a
    2-step forecast of an 8-row bucket; a bucket 4 does not divide."""
    xq, sd = job["serve"]
    eng = _engine(sd, make_mesh({"data": 4}))
    eng.warmup(spatial_shapes=[(16, 16)], batch_sizes=[8],
               rollout_steps=[2])
    return {"predict": eng.predict(xq), "padded": eng.predict(xq[:5]),
            "forecast": eng.forecast(xq, 2), "buckets": eng.buckets(),
            "bad_bucket": _error(lambda: eng.compile_bucket((16, 16), 6))}


def _mlp_stage(p, x):
    return x + torch.tanh(x @ p["w"] + p["b"])


def case_pp(job, tmp):
    per_stage, x, r = job["pp"]
    mesh = make_mesh({"stage": 4})
    stacked = stack_stage_params(per_stage)
    with torch.no_grad():
        outs = {m: pipeline_apply(_mlp_stage, stacked, x, mesh,
                                  n_microbatches=m) for m in (4, 8)}
        three = stack_stage_params(per_stage[:3])
        outs["leading"] = _error(lambda: pipeline_apply(
            _mlp_stage, three, x, mesh))
        outs["indivisible"] = _error(lambda: pipeline_apply(
            _mlp_stage, stacked, x[:6], mesh))
    leaves = {k: v.clone().requires_grad_() for k, v in stacked.items()}
    xg = x.clone().requires_grad_()
    (pipeline_apply(_mlp_stage, leaves, xg, mesh) * r).sum().backward()
    outs["grad"] = {"x": xg.grad, **{k: v.grad for k, v in leaves.items()}}
    return outs


def case_cli(job, tmp):
    """main_2d over the group: every rank in one working directory."""
    from resolution_pde_tpu_torch.cli.main_2d import main

    os.chdir(os.path.join(tmp, "port"))
    out = main(job["cli_argv"], device="cpu")
    return {k: out[k] for k in ("test_loss", "super_resolution", "rollout")} | {
        "history": {k: getattr(out["history"], k)
                    for k in ("train_loss", "val_loss", "lr")}}


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def main():
    tmp, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=world, timeout=timedelta(seconds=120))
    job = torch.load(os.path.join(tmp, "job.pt"), weights_only=False)
    out = {}
    for name in job["cases"]:
        try:
            out[name] = CASES[name](job, tmp)
        except Exception:
            out[name] = "error: " + traceback.format_exc()
    torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
