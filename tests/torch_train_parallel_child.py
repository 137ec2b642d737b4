"""One rank of a data- / tensor-parallel training world for
tests/test_torch_train_parallel.py, or (``--suite _pp``) of a pipeline /
sequence-parallel world for tests/test_torch_pipeline.py.

Imports only the port. The parent test writes the inputs into ``--dir``
(the JAX package's seeded weights and LoRA trees as flat ``.npz`` files,
the batches, a selector dataset and an HF checkpoint); every rank of a
gloo world on the CPU builds the same objects, runs the same cases on its
shard and writes what it saw to ``--dir/w<world>_r<rank>.{json,npz}``,
which the parent holds to the JAX package and to one process.

    python tests/torch_train_parallel_child.py --world 4 --rank R --port P --dir D
    python tests/torch_train_parallel_child.py --world 2 --rank R --port P --dir D
    python tests/torch_train_parallel_child.py --world 4 --suite _pp ...
"""

import argparse
import dataclasses
import json
import os
import signal
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_parallel_child import unflatten  # noqa: E402

S1 = dict(epochs=1, batch_size=2, max_len=1408, grad_accum=1,
          warmup_steps=1, save_every=1000, log_every=1, shuffle_copies=2,
          include_demo=False, learning_rate=1e-3)
S2 = dict(max_seq_len=2048, grad_accum=1, save_every=10_000,
          learning_rate=1e-3)
# the train-stage1 command's run (tests/test_torch_train_parallel.py)
CLI_S1 = dict(epochs=3, batch_size=2, max_len=2048, learning_rate=1e-2)
LORA_SCALE = 2.0
# stage 1 on (data 2, pipe 2): 4 rows a step, 2 microbatches of 2 rows
# (one a data rank)
S1_PP = dict(S1, batch_size=4, pipeline_microbatches=2)
# the pipeline forwards' cases: (stages, data, microbatches, remat grads)
PIPE_CASES = {4: [(4, 1, 8, True), (2, 2, 2, False)], 2: [(2, 1, 4, True)]}


def npz(path: str) -> dict:
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


class Rank:
    def __init__(self, args):
        from cogstream_tpu_torch.config import CogReasonerConfig
        from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer

        self.dir = args.dir
        self.cfg = CogReasonerConfig.tiny()
        self.tok = ByteTokenizer(image_token_id=1000)
        self.out: dict = {}
        self.arrays: dict = {}

    def model(self, name: str = "params"):
        from cogstream_tpu_torch.models import bridge

        return bridge.cogreasoner_from_params(
            unflatten(os.path.join(self.dir, f"{name}.npz")), self.cfg,
            device="cpu")

    def lora(self, name: str):
        from cogstream_tpu_torch.models import bridge

        return bridge.lora_from_params(
            unflatten(os.path.join(self.dir, f"{name}.npz")), device="cpu")

    def batch(self, name: str) -> dict:
        return npz(os.path.join(self.dir, f"{name}.npz"))

    def samples(self):
        from cogstream_tpu_torch.train import data as tdata

        return tdata.load_selector_dataset(os.path.join(self.dir, "qa.json"))

    def keep(self, tag: str, tree) -> None:
        """Record a (whole or local) LoRA-shaped tree in the JAX layout."""
        from cogstream_tpu_torch.models import bridge
        from cogstream_tpu_torch.models.lora import iter_leaves

        for k, v in iter_leaves(bridge.lora_to_params(tree)):
            self.arrays[f"{tag}/{k}"] = v

    def spy_steps(self, module, tag: str):
        """Wrap ``module.make_train_step`` so every step records this
        rank's local adapters (``<tag>_step<i>``)."""
        make = module.make_train_step
        seen = []

        def wrapped(*a, **k):
            step = make(*a, **k)

            def run(params, state, batch):
                state, loss = step(params, state, batch)
                self.keep(f"{tag}_step{len(seen)}", state.lora)
                seen.append(float(loss))
                return state, loss
            return run
        module.make_train_step = wrapped
        return seen, lambda: setattr(module, "make_train_step", make)

    # -- cases ------------------------------------------------------------

    def stage1(self, mesh_sizes, tag: str):
        """``train_stage1`` (dropout 0, the JAX init) on a mesh."""
        from cogstream_tpu_torch.config import LoRAConfig
        from cogstream_tpu_torch.train import stage1

        logs = []
        losses, undo = self.spy_steps(stage1, tag)
        try:
            state = stage1.train_stage1(
                self.model().text, self.cfg, self.tok, self.samples(),
                os.path.join(self.dir, f"{tag}_r{self.rank}"),
                stage1.Stage1Config(**S1, data_parallel=mesh_sizes[0],
                                    model_parallel=mesh_sizes[1]),
                log=logs.append, lora_cfg=LoRAConfig(dropout=0.0),
                lora=self.lora("lora_s1"))
        finally:
            undo()
        self.keep(f"{tag}_whole", state.layout.gather(state.lora))
        self.out[tag] = {"logs": logs, "losses": losses, "step": state.step,
                         "mesh": state.layout.mesh.shape}

    def multimodal(self, mesh):
        """One multimodal step of ``dryrun_multichip`` (B = 2 on data):
        the global loss and each leaf's gradient, summed over data and
        gathered over the model group, and this rank's local gradient."""
        from cogstream_tpu_torch.models.lora import iter_leaves, map_leaves
        from cogstream_tpu_torch.parallel.mesh import (COLLECTIVES, all_reduce,
                                                       all_reduce_grads)
        from cogstream_tpu_torch.parallel.sharding import (
            LoraLayout, cogreasoner_param_specs, shard_cogreasoner)
        from cogstream_tpu_torch.train import trainer
        from cogstream_tpu_torch.train.multimodal import multimodal_loss_fn

        model = shard_cogreasoner(self.model(), self.cfg, mesh)
        whole = self.lora("lora_mm")
        layout = LoraLayout(whole, cogreasoner_param_specs(self.cfg, mesh),
                            mesh)
        lora = layout.shard(whole)
        b = self.batch("batch_mm")
        n_vis = int(b.pop("num_vis_tokens"))
        text = {k: b.pop(k) for k in ("input_ids", "feat_src", "positions",
                                      "labels")}
        b.update(trainer.shard_batch(text, mesh))
        batch = trainer.to_device(b, "cpu")
        COLLECTIVES.clear()
        loss = multimodal_loss_fn(model, lora, batch, LORA_SCALE, n_vis,
                                  remat=True)
        leaves = [t for _, t in iter_leaves(lora)]
        grads = all_reduce_grads(list(torch.autograd.grad(loss, leaves)),
                                 mesh.data_group)
        calls = dict(COLLECTIVES)
        it = iter(grads)
        local = map_leaves(lambda t: next(it), lora)
        self.keep("mm_local_grad", local)
        self.keep("mm_grad", layout.gather(local))
        self.out["mm"] = {"loss": float(all_reduce(loss.detach(),
                                                   mesh.data_group)),
                          "collectives": calls}

    def stage2(self, mesh_sizes, tag: str):
        """``Stage2Trainer`` turns (dropout 0, the JAX init) on a mesh."""
        from cogstream_tpu_torch.config import LoRAConfig
        from cogstream_tpu_torch.train import stage2

        losses, undo = self.spy_steps(stage2, tag)
        try:
            tr = stage2.Stage2Trainer(
                self.model(), self.cfg, self.tok,
                stage2.Stage2Config(**S2, data_parallel=mesh_sizes[0],
                                    model_parallel=mesh_sizes[1]),
                os.path.join(self.dir, f"{tag}_r{self.rank}"),
                total_steps=20, log=lambda *a: None,
                lora_cfg=LoRAConfig(dropout=0.0, include_projector=True),
                lora=self.lora("lora_s2"))
            got = [tr.train_turn(self.batch(b))
                   for b in ("batch_pool", "batch_text")]
        finally:
            undo()
        self.keep(f"{tag}_whole", tr.state.layout.gather(tr.state.lora))
        self.out[tag] = {"losses": got, "step_losses": losses}

    def quantized_step(self, mesh, name: str, w8a8: bool = False):
        """Loss and gathered LoRA gradients of one stage-2 micro-step on a
        quantized base (the JAX package's tree, bridged, then sharded);
        ``w8a8``: the decoder under ``w8a8_prefill`` (``--w8a8-forward``),
        recorded as ``<name>_w8a8`` with its count of int8 products."""
        import dataclasses

        from cogstream_tpu_torch.models.lora import iter_leaves, map_leaves
        from cogstream_tpu_torch.ops import quant
        from cogstream_tpu_torch.parallel.sharding import (
            LoraLayout, cogreasoner_param_specs, shard_cogreasoner)
        from cogstream_tpu_torch.train import trainer
        from cogstream_tpu_torch.train.multimodal import multimodal_loss_fn

        text_cfg = dataclasses.replace(self.cfg.text, w8a8_prefill=w8a8)
        calls0 = quant.int8_mm.calls.get("decoder", 0)
        model = shard_cogreasoner(self.model(name), self.cfg, mesh)
        whole = self.lora("lora_mm")
        layout = LoraLayout(whole, cogreasoner_param_specs(self.cfg, mesh),
                            mesh)
        lora = layout.shard(whole)
        b = self.batch("batch_pool")
        n_vis = int(b.pop("num_vis_tokens"))
        loss = multimodal_loss_fn(model, lora, trainer.to_device(b, "cpu"),
                                  LORA_SCALE, n_vis, remat=True,
                                  text_cfg=text_cfg)
        grads = iter(torch.autograd.grad(
            loss, [t for _, t in iter_leaves(lora)]))
        tag = f"{name}_w8a8" if w8a8 else name
        self.keep(f"{tag}_grad",
                  layout.gather(map_leaves(lambda t: next(grads), lora)))
        self.out[tag] = {"loss": float(loss), "int8_mm":
                         quant.int8_mm.calls.get("decoder", 0) - calls0}

    def save_for_resume(self, mesh):
        """Two text steps (dropout 0.1, accumulation 2) on the mesh, then
        the train state saved (gathered, rank 0 writes)."""
        from cogstream_tpu_torch.config import LoRAConfig
        from cogstream_tpu_torch.parallel.sharding import (
            LoraLayout, qwen2_param_specs, shard_qwen2)
        from cogstream_tpu_torch.train import checkpoint as ckpt
        from cogstream_tpu_torch.train import trainer

        text = shard_qwen2(self.model().text, self.cfg.text, mesh)
        whole = self.lora("lora_s1")
        layout = LoraLayout(whole, qwen2_param_specs(self.cfg.text, mesh),
                            mesh)
        tx = trainer.make_optimizer(1e-2, total_steps=6, warmup_steps=1,
                                    grad_accum=2)
        state = trainer.init_train_state(tx, layout.shard(whole), layout)
        step = trainer.make_train_step(
            tx, trainer.bind_text_loss(LoRAConfig(dropout=0.1), remat=True),
            dropout_seed=9)
        batch = trainer.to_device(self.batch("batch_resume"), "cpu")
        losses = []
        for _ in range(2):
            state, loss = step(text, state, batch)
            losses.append(float(loss))
        ckpt.save_train_state(os.path.join(self.dir, "resume"), state)
        self.out["resume"] = {"losses": losses}

    def stage1_dp(self):
        """``train_stage1`` on a (2, 1) mesh as the ``train-stage1
        --data-parallel 2`` command runs it (the checkpoint, the byte
        tokenizer, the default LoRA recipe with dropout 0.1)."""
        from cogstream_tpu_torch.config import load_hf_config
        from cogstream_tpu_torch.models.checkpoint import (
            load_cogreasoner_from_hf)
        from cogstream_tpu_torch.processor.tokenizer import load_tokenizer
        from cogstream_tpu_torch.train import stage1

        hf = os.path.join(self.dir, "hf")
        cfg = load_hf_config(os.path.join(hf, "config.json"))
        model = load_cogreasoner_from_hf(hf, cfg, device="cpu")
        tok = load_tokenizer(hf, cfg.image_token_index, cfg.text.vocab_size)
        state = stage1.train_stage1(
            model.text, cfg, tok, self.samples(),
            os.path.join(self.dir, "dp_inprocess"),
            stage1.Stage1Config(**CLI_S1, data_parallel=2),
            log=lambda *a: None)
        self.out["stage1_dp"] = {"step": state.step}

    def preempt(self):
        """``train_stage1`` under a ``PreemptionGuard`` on every rank;
        rank 1 signals itself (SIGTERM) as its second step ends."""
        from cogstream_tpu_torch.config import LoRAConfig
        from cogstream_tpu_torch.train import stage1
        from cogstream_tpu_torch.train.trainer import PreemptionGuard

        calls = []
        logs = []
        with PreemptionGuard() as guard:
            def flag():
                calls.append(1)
                if self.rank == 1 and len(calls) == 2:
                    os.kill(os.getpid(), signal.SIGTERM)
                return guard()

            state = stage1.train_stage1(
                self.model().text, self.cfg, self.tok, self.samples(),
                os.path.join(self.dir, "preempt"), stage1.Stage1Config(**S1),
                log=logs.append, lora_cfg=LoRAConfig(dropout=0.0),
                stop_flag=flag)
        self.out["preempt"] = {"step": state.step, "guard": guard(),
                               "logs": logs}

    # -- pipeline and ring cases (tests/test_torch_pipeline.py) -----------

    def text4(self):
        """The 4-layer decoder of the pipeline cases (JAX's params)."""
        from cogstream_tpu_torch.models import bridge

        cfg = dataclasses.replace(self.cfg.text, num_hidden_layers=4)
        return cfg, bridge.qwen2_from_params(
            unflatten(os.path.join(self.dir, "pp_params.npz")), cfg,
            device="cpu")

    def pipe_forward(self, stages, data, M, grads):
        """``pipeline_decoder_forward`` on (data, pipe = stages) with M
        microbatches, without and with the adapters; with ``grads`` the
        adapters' gradients of mean(h * w) (remat; ``w`` a seeded probe:
        mean(h^2) of a normed ``h`` is nearly constant, its gradients
        rounding noise), summed over data and gathered over the stages."""
        from cogstream_tpu_torch.models import qwen2
        from cogstream_tpu_torch.models.lora import iter_leaves, map_leaves
        from cogstream_tpu_torch.parallel.mesh import (COLLECTIVES,
                                                       all_reduce_grads,
                                                       make_pipeline_mesh)
        from cogstream_tpu_torch.parallel.pipeline import (
            pipeline_decoder_forward)
        from cogstream_tpu_torch.parallel.sharding import (PipeLayout,
                                                           stage_qwen2)
        from cogstream_tpu_torch.train import trainer

        tag = f"pp{stages}x{data}x{M}"
        _, whole = self.text4()
        mesh = make_pipeline_mesh(stages, data)
        stage = stage_qwen2(whole, mesh)
        del whole
        lora = self.lora("pp_lora")
        layout = PipeLayout(lora, mesh)
        part = layout.shard(lora)
        b = trainer.shard_batch(self.batch("pp_inputs"), mesh)
        ids, pos, w = (torch.as_tensor(b[k]) for k in ("ids", "pos", "w"))
        emb = qwen2.embed(stage, ids)
        COLLECTIVES.clear()
        for name, ads in (("plain", None), ("lora", [(part, 1.0)])):
            with torch.no_grad():
                out = pipeline_decoder_forward(stage, emb, pos, mesh,
                                               num_microbatches=M,
                                               adapters=ads)
            self.arrays[f"{tag}_{name}"] = out.numpy()
        self.out[tag] = {"hops": COLLECTIVES["ppermute"],
                         "layers": len(stage.layers),
                         "data_index": mesh.data_index}
        if grads:
            h = pipeline_decoder_forward(stage, emb, pos, mesh,
                                         num_microbatches=M,
                                         adapters=[(part, 1.0)], remat=True)
            loss = (h.float() * w).sum() / (h.numel() * mesh.data)
            leaves = [t for _, t in iter_leaves(part)]
            g = all_reduce_grads(list(torch.autograd.grad(loss, leaves)),
                                 mesh.data_group)
            it = iter(layout.gather_leaves(g))
            self.keep(f"{tag}_grad", map_leaves(lambda t: next(it), lora))
            self.out[tag]["hops_with_grad"] = COLLECTIVES["ppermute"]

    def ring(self):
        """The ring over every rank, with padding, at the default and a
        3-slot fold chunk (this rank's shard of the output)."""
        from cogstream_tpu_torch.ops.ring_attention import (
            ring_causal_gqa_attention)
        from cogstream_tpu_torch.parallel.mesh import SequenceMesh
        from cogstream_tpu_torch.models.qwen2 import sequence_shard

        sp = SequenceMesh(self.world)
        b = self.batch("ring_inputs")
        q, k, v, pos = (sequence_shard(torch.as_tensor(b[x]), sp.size,
                                       sp.sp_index)
                        for x in ("q", "k", "v", "pos"))
        for chunk in (1024, 3):
            self.arrays[f"ring_c{chunk}"] = ring_causal_gqa_attention(
                q, k, v, pos, pos, sp.sp_group, kv_chunk=chunk).numpy()

    def forward_sp(self):
        """``qwen2_forward_sp`` of the tiny decoder (this rank's shard)."""
        from cogstream_tpu_torch.models import qwen2
        from cogstream_tpu_torch.parallel.mesh import SequenceMesh

        sp = SequenceMesh(self.world)
        text = self.model().text
        b = self.batch("sp_inputs")
        emb = qwen2.embed(text, torch.as_tensor(b["ids"]))
        with torch.no_grad():
            self.arrays["fwd_sp"] = qwen2.qwen2_forward_sp(
                text, emb, torch.as_tensor(b["pos"]), sp).numpy()

    def multimodal_sp(self):
        """``multimodal_loss_fn(sp=)`` on ``dryrun_multichip``'s batch: the
        loss and the gradients summed over the sp group."""
        from cogstream_tpu_torch.models.lora import iter_leaves, map_leaves
        from cogstream_tpu_torch.parallel.mesh import (COLLECTIVES,
                                                       SequenceMesh,
                                                       all_reduce,
                                                       all_reduce_grads)
        from cogstream_tpu_torch.train import trainer
        from cogstream_tpu_torch.train.multimodal import multimodal_loss_fn

        sp = SequenceMesh(self.world)
        model = self.model()
        lora = self.lora("lora_mm")
        b = self.batch("batch_mm")
        n_vis = int(b.pop("num_vis_tokens"))
        COLLECTIVES.clear()
        loss = multimodal_loss_fn(model, lora, trainer.to_device(b, "cpu"),
                                  LORA_SCALE, n_vis, remat=True, sp=sp)
        leaves = [t for _, t in iter_leaves(lora)]
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = all_reduce_grads([torch.zeros_like(p) if x is None else x
                              for x, p in zip(g, leaves)], sp.sp_group)
        it = iter(g)
        self.keep("mm_sp_grad", map_leaves(lambda t: next(it), lora))
        share = float(loss)     # before the sum (in place on the value)
        self.out["mm_sp"] = {"loss": float(all_reduce(loss.detach(),
                                                      sp.sp_group)),
                             "share": share,
                             "hops": COLLECTIVES["ppermute"]}

    def stage2_sp(self):
        """Two ``Stage2Trainer`` turns with ``sequence_parallel`` = the
        world (dropout 0, the JAX init)."""
        from cogstream_tpu_torch.config import LoRAConfig
        from cogstream_tpu_torch.train import stage2

        losses, undo = self.spy_steps(stage2, "s2sp")
        try:
            tr = stage2.Stage2Trainer(
                self.model(), self.cfg, self.tok,
                stage2.Stage2Config(**S2, sequence_parallel=self.world),
                os.path.join(self.dir, f"s2sp_r{self.rank}"),
                total_steps=20, log=lambda *a: None,
                lora_cfg=LoRAConfig(dropout=0.0, include_projector=True),
                lora=self.lora("lora_s2"))
            got = [tr.train_turn(self.batch(b))
                   for b in ("batch_pool", "batch_text")]
            tr.finish()
        finally:
            undo()
        self.keep("s2sp_whole", tr.state.lora)
        self.out["s2sp"] = {"losses": got, "step_losses": losses}

    def stage1_pp(self):
        """``train_stage1`` on (data 2, pipe 2) (dropout 0, the JAX init):
        its logs, the gathered adapters, the files it wrote."""
        from cogstream_tpu_torch.config import LoRAConfig
        from cogstream_tpu_torch.train import stage1

        logs = []
        state = stage1.train_stage1(
            self.model().text, self.cfg, self.tok, self.samples(),
            os.path.join(self.dir, "s1pp"),
            stage1.Stage1Config(**S1_PP, data_parallel=2,
                                pipeline_stages=2),
            log=logs.append, lora_cfg=LoRAConfig(dropout=0.0),
            lora=self.lora("lora_s1"))
        self.keep("s1pp_whole", state.layout.gather(state.lora))
        self.out["s1pp"] = {"logs": logs, "step": state.step,
                            "mesh": state.layout.mesh.shape,
                            "layers": len(state.lora["layers"])}

    def pipe_resume(self):
        """Two text steps (dropout 0, accumulation 2) on (data 1, pipe 2),
        then the train state saved (gathered, rank 0 writes)."""
        from cogstream_tpu_torch.config import LoRAConfig
        from cogstream_tpu_torch.parallel.mesh import make_pipeline_mesh
        from cogstream_tpu_torch.parallel.sharding import (PipeLayout,
                                                           stage_qwen2)
        from cogstream_tpu_torch.train import checkpoint as ckpt
        from cogstream_tpu_torch.train import trainer

        mesh = make_pipeline_mesh(2, 1)
        text = stage_qwen2(self.model().text, mesh)
        whole = self.lora("lora_s1")
        layout = PipeLayout(whole, mesh)
        tx = trainer.make_optimizer(1e-2, total_steps=6, warmup_steps=1,
                                    grad_accum=2)
        state = trainer.init_train_state(tx, layout.shard(whole), layout)
        step = trainer.make_train_step(
            tx, trainer.bind_text_loss(LoRAConfig(dropout=0.0), remat=True,
                                       pipeline=(mesh, 2)), mesh=mesh)
        batch = trainer.to_device(self.batch("batch_resume"), "cpu")
        losses = []
        for _ in range(2):
            state, loss = step(text, state, batch)
            losses.append(float(loss))
        ckpt.save_train_state(os.path.join(self.dir, "pp_resume"), state)
        self.out["pp_resume"] = {"losses": losses}

    # -- worlds -----------------------------------------------------------

    def world4(self):
        from cogstream_tpu_torch.parallel.mesh import make_mesh

        self.stage1((2, 2), "s1")
        self.multimodal(make_mesh(2, 2))
        self.stage2((2, 2), "s2")

    def world2(self):
        from cogstream_tpu_torch.parallel.mesh import make_mesh

        tp = make_mesh(1, 2)
        for name in ("params_int8", "params_nf4"):
            self.quantized_step(tp, name)
        self.quantized_step(tp, "params_int8", w8a8=True)
        self.save_for_resume(tp)
        self.stage1_dp()
        self.preempt()

    def world4_pp(self):
        for case in PIPE_CASES[4]:
            self.pipe_forward(*case)
        self.ring()
        self.multimodal_sp()
        self.stage1_pp()

    def world2_pp(self):
        for case in PIPE_CASES[2]:
            self.pipe_forward(*case)
        self.ring()
        self.forward_sp()
        self.multimodal_sp()
        self.stage2_sp()
        self.pipe_resume()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--suite", default="",
                    help="'_pp': the pipeline / sequence-parallel cases")
    ap.add_argument("--timeout", type=float, default=300,
                    help="seconds a collective waits for the other ranks")
    args = ap.parse_args()
    torch.set_num_threads(1)
    from cogstream_tpu_torch.parallel.distributed import initialize_if_needed

    initialize_if_needed(f"tcp://127.0.0.1:{args.port}", args.world,
                         args.rank, backend="gloo", timeout_s=args.timeout)
    rank = Rank(args)
    rank.rank, rank.world = args.rank, args.world
    stem = os.path.join(args.dir, f"w{args.world}{args.suite}_r{args.rank}")
    try:
        getattr(rank, f"world{args.world}{args.suite}")()
    except Exception:  # noqa: BLE001 — recorded for the parent, then rc 1
        rank.out["error"] = traceback.format_exc()
        with open(stem + ".json", "w") as f:
            json.dump(rank.out, f)
        return 1
    np.savez(stem + ".npz", **rank.arrays)
    with open(stem + ".json", "w") as f:
        json.dump(rank.out, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
