"""Training traffic: the family's training loop, as users call it, on the
set-up's one model.

Set-up makes the weights and the mix's distinct batches from the seed, builds
the port's model on those weights, and drives it through its first
`checked_steps` steps by the window's own call: one step, then the rest,
each batch a different one. Before and between them it reads what the check
compares: each step's loss, the first gradient as the optimizer got it
(for SGD the change over the learning rate, for row-wise AdaGrad the root
of D times its accumulator after one step), and each leaf's change after
the checked steps; those calls warm every shape. The window then calls
the loop, `steps_per_call` steps a call on the cycled batches, until
`--seconds` are spent; every call ends in a synchronize. A traced run
profiles its second call, of `traced_steps` steps where the mix gives
that (at most `steps_per_call`): the profiler loses activity records
over a long, dense call.

After the window the program's state is freed, the weights are made again
from the seed, and the plain reference runs the checked steps from them.

A configuration with a `placement` of several cards runs on a mesh of
that many ranks, one process each: every rank makes the same global
batches and its own shard of the table from the seed (the whole table is
never made), the loop trains the sharded model, the readings of the
first steps are summed over the ranks, the ranks' copies of the towers
are held to each other after them, rank 0's clock ends the window for
all, and rank 0 alone runs the reference, shard by shard.
"""
from __future__ import annotations

import time

import torch

from portbench import check, generate, port, weights
from portbench.reference import train as reftrain
from portbench.reference.numerics import Precision, exact
from portbench.spec import load_module


class Runner:
    """One rank's part of a training cell: every rank of a cell on several
    cards runs it alike (`rank`, with the group's rendezvous `port`), and
    rank 0 alone runs the reference."""

    def __init__(self, cell, seed: int, device, log, rank: int = 0,
                 port_no: int | None = None):
        self.cell, self.seed, self.device, self.log = cell, seed, device, log
        self.cfg, self.traffic = cell.config, cell.traffic
        self.fam = load_module("families", self.cfg["family"])
        self.ref = self.fam.reference
        self.pcfg = self.fam.port_config(self.cfg)
        self.sparse = self.cfg["sparse_optimizer"]
        self.dense_lr = float(self.cfg["dense_optimizer"]["lr"])
        self.world = cell.chips
        cards = self.cfg.get("placement", {}).get("cards", 1)
        if cards != self.world:
            raise ValueError(f"{cell.name} runs on {self.world} cards, its "
                             f"configuration is placed on {cards}")
        self.rank, self.port_no, self.mesh = rank, port_no, None
        self.step_no = 0

    # -- the program ---------------------------------------------------------
    def _call(self, steps: int, log_every: int = 0):
        nb = len(self.batches)
        batches = [self.batches[(self.step_no + i) % nb]
                   for i in range(steps)]
        self.step_no += steps
        return self.fam.train(
            self.pcfg, self.model, batches, steps, sparse_opt=self.opt,
            dense_lr=self.dense_lr,
            device_prefetch=int(self.traffic["device_prefetch"]),
            log_every=log_every, mesh=self.mesh)

    def _flat(self, batch) -> torch.Tensor:
        cat = torch.from_numpy(batch["cat"]).to(self.device).long()
        return (cat + self.offsets[:, None]).reshape(-1)

    def setup(self):
        cfg = self.cfg
        if self.world > 1:
            self.device, self.mesh = port.init_mesh(
                self.world, self.rank, self.port_no, self.device)
        dev = self.device
        nbytes = weights.table_bytes(cfg)
        self.log(f"tables: {nbytes} bytes ({nbytes / 1e9:.2f} GB), "
                 f"{weights.offsets(cfg['vocab_sizes'])[-1]} rows of "
                 f"{cfg['dim']}; {nbytes / self.world / 1e9:.2f} GB a card "
                 f"on {self.world}")
        self.opt = port.sparse_optimizer(self.sparse)
        self.model = self.fam.port_model(
            self.pcfg, cfg,
            weights.make_tables(cfg, self.seed, dev, self.rank, self.world),
            weights.make_leaves(self.ref, cfg, self.seed, dev), self.opt,
            mesh=self.mesh)
        self.batches = generate.train_batches(
            cfg["vocab_sizes"], cfg["num_dense"], self.traffic, self.seed,
            dev)
        self.offsets = torch.tensor(weights.offsets(cfg["vocab_sizes"])[:-1],
                                    dtype=torch.int64, device=dev)
        self.unique = [int(torch.unique(self._flat(b)).numel())
                       for b in self.batches]
        self.program = self._first_steps()

    def _first_steps(self) -> dict:
        """The program's readings over its first `checked_steps` steps."""
        k = int(self.traffic["checked_steps"])
        ntables, d = len(self.cfg["vocab_sizes"]), self.cfg["dim"]
        self.u = torch.unique(torch.cat([self._flat(b)
                                         for b in self.batches[:k]]))
        bounds = torch.tensor(weights.offsets(self.cfg["vocab_sizes"]),
                              dtype=torch.int64, device=self.device)
        self.table_of_row = torch.searchsorted(bounds, self.u, right=True) - 1
        # This rank's rows of them: all of them on one card, those that
        # its shard holds (at slot r // world) on several.
        mine = self.u % self.world == self.rank
        slots, tor = self.u[mine] // self.world, self.table_of_row[mine]
        data = self.model.tables.data
        rows0 = data[slots].clone()
        towers = self.fam.tower_leaves(self.model)
        w0 = {n: p.detach().clone() for n, p in towers.items()}
        losses = list(self._call(1, log_every=1).losses)
        with torch.no_grad():
            grad = reftrain.leaf_norms(
                {n: (w0[n] - p) / self.dense_lr for n, p in towers.items()})
            if self.sparse["name"] == "rowwise_adagrad":
                acc = self.model.emb_state.accum[slots]
                touched = (acc > 0).sum().double()
                sq = reftrain.sq_by_table(acc.double() * d, tor, ntables)
            else:
                rows1 = data[slots]
                touched = (rows1 != rows0).any(dim=1).sum().double()
                g = (rows0 - rows1) / float(self.sparse["lr"])
                sq = reftrain.sq_by_table((g.double() ** 2).sum(dim=1),
                                          tor, ntables)
                del g, rows1
            sums = port.all_reduce(torch.cat([sq, touched[None]]))
            grad.update({f"table.{t}": v for t, v in
                         enumerate(sums[:-1].sqrt().tolist())})
            touched = int(sums[-1])
        losses += list(self._call(k - 1, log_every=1).losses)
        with torch.no_grad():
            change = reftrain.leaf_norms(
                {n: p - w0[n] for n, p in towers.items()})
            dx = data[slots] - rows0
            sq = port.all_reduce(reftrain.sq_by_table(
                (dx.double() ** 2).sum(dim=1), tor, ntables))
            change.update({f"table.{t}": v
                           for t, v in enumerate(sq.sqrt().tolist())})
        out = {"loss": losses, "grad": grad, "change": change,
               "touched": touched}
        if self.world > 1:
            out["replica_gap"] = self._replica_gap(towers)
        return out

    def _replica_gap(self, towers: dict) -> float:
        """The widest gap, element by element, between the cards' copies of
        the towers: 0 while every card steps them by the same all-reduced
        gradient."""
        gap = 0.0
        for p in towers.values():
            hi = port.all_reduce(p.detach().clone(), "max")
            lo = port.all_reduce(p.detach().clone(), "min")
            gap = max(gap, float((hi - lo).abs().max()))
        return gap

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float, tracer=None) -> dict:
        """Call the loop until `seconds` are spent; with a `tracer`, its
        second call is profiled and the others timed by CUDA events."""
        steps = int(self.traffic["steps_per_call"])
        traced_steps = min(steps, int(self.traffic.get("traced_steps",
                                                        steps)))
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        facts = {"event_s": 0.0, "event_steps": 0, "traced_batches": [],
                 "phases": {}}
        calls, total, ends = 0, 0, []
        t0 = time.perf_counter()
        while True:
            traced = tracer is not None and calls == 1
            before, first = port.telemetry_phases(), self.step_no
            if traced:
                with tracer:
                    self._call(traced_steps)
                facts["traced_batches"] = [
                    (first + i) % len(self.batches)
                    for i in range(traced_steps)]
            elif cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                self._call(steps)
                e1.record()
                e1.synchronize()
                facts["event_s"] += e0.elapsed_time(e1) / 1e3
                facts["event_steps"] += steps
            else:
                self._call(steps)
            if not traced:
                after = port.telemetry_phases()
                for name, (n, s) in after.items():
                    n0, s0 = before.get(name, (0, 0.0))
                    c, t = facts["phases"].get(name, (0, 0.0))
                    facts["phases"][name] = (c + n - n0, t + s - s0)
            calls += 1
            total += traced_steps if traced else steps
            ends.append(time.perf_counter() - t0)
            done = ends[-1] >= seconds and (
                tracer is None or calls > 1)
            # rank 0's clock decides for every rank
            if port.all_reduce(torch.tensor(
                    [float(done and self.rank == 0)], device=self.device)):
                break
        elapsed = time.perf_counter() - t0
        batch = int(self.traffic["batch"])
        facts.update(
            steps=total, examples=total * batch, window_s=elapsed,
            peak_bytes=int(port.all_reduce(torch.tensor(
                [torch.cuda.max_memory_allocated(self.device) if cuda else 0],
                dtype=torch.int64, device=self.device), "max")),
            world=self.world,
            trace=None if tracer is None else tracer.trace,
            unique=self.unique, n_ids=len(self.cfg["vocab_sizes"]) * batch,
            dim=self.cfg["dim"],
            adagrad=self.sparse["name"] == "rowwise_adagrad",
            flops_per_step=3 * self.ref.forward_flops(self.cfg) * batch)
        self.log(f"window: {total} steps in {calls} calls of {steps}, "
                 f"{elapsed:.6f} s")
        self.log("calls_ms: " + " ".join(
            f"{(b - a) * 1e3:.1f}" for a, b in zip([0.0] + ends, ends)))
        # A cell on several cards reports its rate under a name of its own:
        # its runs spread wider, which sets a bound of its own.
        name = "train_examples_per_s" + (".mesh" if self.world > 1 else "")
        return {"attempted": total, "failed": 0,
                "e2e": {name: total * batch / elapsed}, "facts": facts}

    def release(self):
        """Free the program's state before the reference runs, and leave
        the group."""
        self.model = self.opt = None
        if self.mesh is not None:
            self.mesh = None
            port.leave_mesh()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------
    def reference(self, precision: str, half: bool = False) -> dict:
        """The plain reference's readings over the checked steps, from
        weights made again from the seed (`half`: with that fault)."""
        k = int(self.traffic["checked_steps"])
        dev, cfg = self.device, self.cfg
        with exact():
            rows0 = weights.initial_rows(cfg, self.seed, self.world, self.u,
                                         dev)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            leaves0 = weights.make_leaves(self.ref, cfg, self.seed, dev)
            batches = []
            for b in self.batches[:k]:
                pos = torch.searchsorted(self.u, self._flat(b))
                batches.append({
                    "dense": torch.from_numpy(b["dense"]).to(dev),
                    "label": torch.from_numpy(b["label"]).to(dev),
                    "pos": pos.reshape(b["cat"].shape)})
            return reftrain.steps(self.ref, cfg, leaves0, rows0,
                                  self.table_of_row, batches, self.sparse,
                                  self.dense_lr, Precision(precision), half)

    def numbers(self) -> dict:
        nums = check.train_gaps(self.program, self.reference("f32"))
        if "replica_gap" in self.program:
            nums["replica_gap"] = self.program["replica_gap"]
        return nums

    def control_numbers(self) -> dict:
        """The control: the reference in the next precision below the
        configuration's, in the program's place."""
        return check.train_gaps(self.reference("lower"),
                                self.reference("f32"))

    def fault_numbers(self) -> dict:
        """{fault: numbers} of the faults a training cell can have, planted
        in the reference put in the program's place. A step that returns
        its state unchanged reads 1 on the gradient and the change by their
        definition and needs no run."""
        ref = self.reference("f32")
        return {"half_batch": check.train_gaps(
            self.reference("f32", half=True), ref)}

