"""Consensus traffic: chunks of micrographs through the program's
``run_consensus_batch``, the batch entry of directory consensus.

Set-up makes the configuration's micrographs (a corpus of its own
seed, ordered by the run's seed), pads them on the host into chunks
(the program's ``PaddedBatch``), and runs every chunk once, which
settles the escalation memo and the allocator.  A
step runs the next chunk, as the chunk loop does: host batch in,
packed result fetched to the host.  The check, after the window, runs
the plain reference over a sample of the micrographs that the window
finished, drawn from the seed, with the micrograph of the most cliques
among them.
"""

from __future__ import annotations

import numpy as np

from portbench import compare, synth
from portbench.reference import consensus as ref_consensus


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.k = len(config["pickers"])
        sizes = config["box_size"]
        self.box = (np.asarray(sizes, np.float32)
                    if isinstance(sizes, list) else float(sizes))
        self.sizes = np.broadcast_to(np.asarray(sizes, np.float32),
                                     (self.k,))
        self.chunks, self.raw = [], []
        self.last = {}
        self.turn = 0
        self.reports = []

    # -- set-up -----------------------------------------------------
    def make_inputs(self):
        """The configuration's corpus (made from its ``corpus_seed``,
        the same for every run) in chunks of fixed membership; the
        run's seed orders the micrographs inside each chunk and the
        rows of every picker's list.  So every seed does the same work
        (the capacities a chunk escalates to are maxima over its
        micrographs) on inputs in another order."""
        from repic_tpu_torch.parallel.batching import PaddedBatch

        cfg = self.config
        gen = synth.generator(cfg["generator"])
        corpus = np.random.default_rng(synth.rng_seed(cfg["corpus_seed"], 0))
        order = np.random.default_rng(synth.rng_seed(self.seed, 0))
        m_all, m, n = cfg["micrographs"], cfg["chunk"], cfg["n_pad"]
        for c0 in range(0, m_all, m):
            mics = [gen(corpus, pickers=self.k, **cfg["generator_args"])
                    for _ in range(m)]
            mics = [[(xy[p], cf[p]) for xy, cf in mics[i]
                     for p in [order.permutation(len(xy))]]
                    for i in order.permutation(m)]
            xy = np.zeros((m, self.k, n, 2), np.float32)
            conf = np.zeros((m, self.k, n), np.float32)
            mask = np.zeros((m, self.k, n), bool)
            counts = np.zeros((m, self.k), np.int32)
            for i, mic in enumerate(mics):
                for p, (pxy, pconf) in enumerate(mic):
                    if len(pxy) > n:
                        raise ValueError(
                            f"{len(pxy)} particles exceed n_pad {n}")
                    xy[i, p, :len(pxy)] = pxy
                    conf[i, p, :len(pxy)] = pconf
                    mask[i, p, :len(pxy)] = True
                    counts[i, p] = len(pxy)
            names = tuple(f"mic_{c0 + i:05d}" for i in range(m))
            self.chunks.append(PaddedBatch(xy, conf, mask, names, counts))
            self.raw.append(mics)

    def setup(self):
        self.make_inputs()
        for _ in range(len(self.chunks)):
            self.step()
        self.turn = 0
        self.reports.clear()

    # -- the timed step ---------------------------------------------
    @property
    def cycle(self) -> int:
        """Steps of one pass over the inputs."""
        return len(self.chunks)

    def step(self) -> int:
        from repic_tpu_torch.pipeline.consensus import (
            consume_dispatch_report,
            run_consensus_batch,
        )

        i = self.turn % len(self.chunks)
        self.turn += 1
        _, packed = run_consensus_batch(
            self.chunks[i], self.box,
            threshold=self.config["threshold"],
            solver=self.traffic["solver"],
            device=self.device,
            full=True,
        )
        self.last[i] = packed
        report = consume_dispatch_report()
        if report is not None:
            self.reports.append(report)
        return self.chunks[i].num_micrographs

    def work(self):
        """Counted work of a step: none is counted for consensus."""
        return None

    def counters(self) -> dict:
        return {"dispatches": [r["dispatches"] for r in self.reports]}

    # -- the check --------------------------------------------------
    def sample(self) -> list[tuple[int, int]]:
        """(chunk, row) pairs: ``check_per_chunk`` rows of every chunk
        the window ran, drawn from the seed, and the row of the most
        cliques."""
        rng = np.random.default_rng(synth.rng_seed(self.seed, 1))
        per = self.traffic.get("check_per_chunk", 2)
        out = []
        best, best_n = None, -1
        for c in sorted(self.last):
            packed = self.last[c]
            m = self.chunks[c].num_micrographs
            rows = rng.choice(m, size=min(per, m), replace=False)
            out += [(c, int(r)) for r in rows]
            n_valid = (packed[:m, 1:, self.k + 6] > 0.5).sum(1)
            r = int(np.argmax(n_valid))
            if n_valid[r] > best_n:
                best, best_n = (c, r), int(n_valid[r])
        if best is not None and best not in out:
            out.append(best)
        return out

    def reference(self, c: int, r: int, precision: str = "float32"):
        mic = self.raw[c][r]
        return ref_consensus.consensus(
            [v[0] for v in mic], [v[1] for v in mic], self.sizes,
            self.config["threshold"], precision=precision)

    def numbers(self, program_outputs=None) -> dict:
        """The run's numbers: the program's kept results (or
        ``program_outputs``, ``{(chunk, row): decoded}``) against the
        float32 reference."""
        per = []
        for c, r in self.sample():
            port = (program_outputs[c, r] if program_outputs is not None
                    else compare.decode_full(self.last[c][r], self.k))
            per.append(compare.consensus_numbers(port, self.reference(c, r)))
        return compare.fold_consensus(per)

    def control_numbers(self) -> dict:
        """The control's numbers: the reference computed in bfloat16
        put in the program's place, on the same sample."""
        outs = {(c, r): as_program_output(self.reference(c, r, "bfloat16"))
                for c, r in self.sample()}
        return self.numbers(outs)

    def release(self):
        """Drop the program's device state before the reference runs;
        the fetched results stay."""
        import gc

        gc.collect()


def as_program_output(cl) -> dict:
    """A reference result in the decoded layout of the program's
    packed result (the control's stand-in for the program)."""
    return dict(
        members=cl.members, rep_xy=cl.rep_xy, w=cl.w,
        confidence=cl.confidence, rep_slot=cl.rep_slot,
        picked=cl.picked, valid=np.ones(len(cl.w), bool),
    )
