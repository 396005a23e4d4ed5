"""The port's checkpointing, data pipeline and runtime supervisor
(src/repro_torch/checkpoint/, data/, runtime/heartbeat.py and
supervisor.py), mirroring tests/test_checkpoint_runtime.py (its
``plan_remesh`` cases wait for the mesh), plus what torch adds: a bf16
round trip that must be bit-exact, a ``save_async`` whose tree is updated
in place before ``wait()`` (the snapshot must still be written), a
restore that aliases nothing, and batches bit-identical to the
reference's pipeline.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import Prefetcher, SyntheticLMDataset
from repro_torch.runtime.heartbeat import StepMonitor
from repro_torch.runtime.supervisor import SimulatedFailure, Supervisor


def _state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v)},
            "step_val": torch.tensor(v)}


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_n=3)
        st = _state(3.5)
        mgr.save(10, st, {"note": "x"})
        assert mgr.steps() == [10]
        back = mgr.restore(10, _state())
        assert torch.equal(back["params"]["w"], st["params"]["w"])
        assert mgr.meta(10)["note"] == "x"

    def test_keep_n_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_n=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, _state(s))
        assert mgr.steps() == [3, 4]

    def test_async_write_and_wait(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_n=2)
        mgr.save_async(5, _state(5.0))
        mgr.wait()
        assert mgr.latest_step() == 5

    def test_atomicity_no_partial_dirs(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(7, _state())
        names = os.listdir(tmp_path)
        assert all(".tmp." not in n for n in names)

    def test_restore_shape_mismatch_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"w": torch.zeros(2, 2)})
        with pytest.raises(ValueError):
            mgr.restore(1, {"w": torch.zeros(3, 3)})

    def test_bf16_roundtrip_is_exact(self, tmp_path):
        """bf16 leaves travel as float32 and come back bit for bit, in
        the template's dtype, with its requires_grad; the moments' float32
        and the step's int32 too."""
        g = torch.Generator().manual_seed(0)
        w = (torch.randn(64, 33, generator=g) * 3).to(torch.bfloat16)
        w[0, :4] = torch.tensor([0.0, -0.0, 1e-38, 3e38]).to(torch.bfloat16)
        tree = {"params": {"w": w.requires_grad_(True)},
                "opt": {"mu": torch.randn(64, 33, generator=g),
                        "step": torch.tensor(20, dtype=torch.int32)}}
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(20, tree)
        tmpl = {"params": {"w": torch.zeros(64, 33, dtype=torch.bfloat16,
                                            requires_grad=True)},
                "opt": {"mu": torch.zeros(64, 33),
                        "step": torch.tensor(0, dtype=torch.int32)}}
        back = mgr.restore(20, tmpl)
        bw = back["params"]["w"]
        assert bw.dtype == torch.bfloat16 and bw.requires_grad
        assert torch.equal(bw.view(torch.int16), w.detach().view(torch.int16))
        assert torch.equal(back["opt"]["mu"], tree["opt"]["mu"])
        assert back["opt"]["step"].dtype == torch.int32
        assert int(back["opt"]["step"]) == 20

    def test_save_async_snapshots_before_returning(self, tmp_path):
        """The tree is overwritten in place (as the optimizer does) right
        after ``save_async`` returns: the checkpoint holds the values at
        the call, for float32 (whose ``.numpy()`` would share memory) and
        bf16 leaves alike."""
        tree = {"w": torch.full((256, 256), 1.0),
                "b": torch.full((8,), 2.0, dtype=torch.bfloat16)}
        mgr = CheckpointManager(str(tmp_path))
        mgr.save_async(3, tree)
        tree["w"].fill_(-7.0)
        tree["b"].fill_(-7.0)
        mgr.wait()
        back = mgr.restore(3, {"w": torch.zeros(256, 256),
                               "b": torch.zeros(8, dtype=torch.bfloat16)})
        assert torch.equal(back["w"], torch.full((256, 256), 1.0))
        assert torch.equal(back["b"], torch.full((8,), 2.0,
                                                 dtype=torch.bfloat16))

    def test_restore_aliases_nothing(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        tmpl = _state()
        mgr.save(1, _state(1.0))
        a = mgr.restore(1, tmpl)
        b = mgr.restore(1, tmpl)
        a["params"]["w"].add_(5.0)
        assert torch.equal(b["params"]["w"], torch.full((4, 4), 1.0))
        assert a["params"]["w"].data_ptr() != tmpl["params"]["w"].data_ptr()

    def test_scalar_leaves_come_back_as_scalars(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(2, {"acc": 7.5, "n": 3})
        back = mgr.restore(2, {"acc": 0.0, "n": 0})
        assert back == {"acc": 7.5, "n": 3}
        assert isinstance(back["n"], int)


class TestMonitor:
    def test_straggler_detection(self):
        mon = StepMonitor(mad_threshold=4.0)
        for step in range(16):
            for h in range(8):
                mon.record(h, step, 1.0 + (3.0 if h == 5 else 0.0))
        assert mon.stragglers() == [5]

    def test_dead_host_detection(self):
        now = [0.0]
        mon = StepMonitor(dead_after=10.0, clock=lambda: now[0])
        for h in range(4):
            mon.record(h, 0, 1.0)
        now[0] = 5.0
        for h in range(3):  # host 3 goes silent
            mon.record(h, 1, 1.0)
        now[0] = 20.0
        for h in range(3):
            mon.record(h, 2, 1.0)
        assert mon.dead_hosts() == [3]
        assert mon.healthy_hosts() == [0, 1, 2]


class TestSupervisor:
    def test_recovers_and_replays_deterministically(self, tmp_path):
        """A failure at step 7 restores step 5's checkpoint and replays —
        final state identical to a failure-free run."""
        data = SyntheticLMDataset(vocab=97, seq_len=8, global_batch=4)

        def step_fn(state, step):
            batch = data.batch_at(step)
            inc = float(batch["tokens"].sum() % 1000)
            return {"acc": state["acc"] + inc}

        def run(fail_at):
            mgr = CheckpointManager(str(tmp_path / f"ck{fail_at}"), keep_n=2)
            sup = Supervisor(mgr, ckpt_every=5)
            tripped = []

            def hook(step):
                if step == fail_at and not tripped:
                    tripped.append(step)
                    raise SimulatedFailure(f"node died at {step}")

            return sup.run(
                {"acc": 0.0}, step_fn, num_steps=12,
                failure_hook=hook if fail_at else None,
            ), sup

        clean, _ = run(0)
        failed, sup = run(7)
        assert failed["acc"] == clean["acc"]
        assert sup.stats.failures == 1 and sup.stats.restores == 1

    def test_replay_of_an_in_place_tensor_state(self, tmp_path):
        """A tensor state updated in place (as the trainer's) replays from
        its checkpoint to the failure-free result."""
        def step_fn(state, step):
            state["w"].mul_(1.5).add_(step)
            return state

        def run(fail_at):
            mgr = CheckpointManager(str(tmp_path / f"t{fail_at}"), keep_n=2)
            sup = Supervisor(mgr, ckpt_every=4)
            tripped = []

            def hook(step):
                if step == fail_at and not tripped:
                    tripped.append(step)
                    raise SimulatedFailure("lost")

            out = sup.run({"w": torch.ones(3)}, step_fn, num_steps=10,
                          failure_hook=hook)
            return out, sup

        clean, _ = run(-1)
        failed, sup = run(6)
        assert torch.equal(failed["w"], clean["w"])
        assert (sup.stats.failures, sup.stats.restores) == (1, 1)
        assert sup.stats.steps_run == 12  # steps 4 and 5 ran twice

    def test_gives_up_after_max_retries(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_n=1)
        sup = Supervisor(mgr, ckpt_every=100, max_retries=2)

        def hook(step):
            raise SimulatedFailure("always")

        with pytest.raises(SimulatedFailure):
            sup.run({"x": 0}, lambda s, i: s, num_steps=5,
                    failure_hook=hook)


class TestData:
    def test_deterministic_across_restart(self):
        d1 = SyntheticLMDataset(101, 16, 8, seed=3)
        d2 = SyntheticLMDataset(101, 16, 8, seed=3)
        b1, b2 = d1.batch_at(42), d2.batch_at(42)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])

    def test_hosts_get_distinct_shards(self):
        a = SyntheticLMDataset(101, 16, 8, host_id=0, num_hosts=2)
        b = SyntheticLMDataset(101, 16, 8, host_id=1, num_hosts=2)
        assert a.host_batch == 4
        assert not np.array_equal(
            a.batch_at(0)["tokens"], b.batch_at(0)["tokens"]
        )

    def test_labels_are_shifted_tokens(self):
        d = SyntheticLMDataset(101, 16, 4)
        b = d.batch_at(0)
        np.testing.assert_array_equal(
            b["labels"][:, :-1], b["tokens"][:, 1:]
        )

    def test_prefetcher_yields_in_order(self):
        d = SyntheticLMDataset(101, 8, 2)
        it = Prefetcher(iter([d.batch_at(i) for i in range(5)]), depth=2)
        outs = list(it)
        assert len(outs) == 5
        np.testing.assert_array_equal(
            outs[3]["tokens"], d.batch_at(3)["tokens"]
        )

    @pytest.mark.parametrize("seed,host", [(0, 0), (3, 1), (11, 2)])
    def test_batches_match_the_reference(self, seed, host):
        """Bit-identical to src/repro/data/pipeline.py for the same
        (seed, step, host), at gpt2's vocabulary and width."""
        ref = pytest.importorskip("repro.data.pipeline")
        a = SyntheticLMDataset(50257, 128, 8, seed=seed, host_id=host,
                               num_hosts=4)
        b = ref.SyntheticLMDataset(50257, 128, 8, seed=seed, host_id=host,
                                   num_hosts=4)
        for step in (0, 1, 20, 29):
            x, y = a.batch_at(step), b.batch_at(step)
            for k in ("tokens", "labels"):
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])
