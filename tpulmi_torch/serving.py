"""Staging of query batches for `LearnedIndex.search_stream` on a CUDA device.

`QueryStager` keeps a rotating set of slots. A slot owns pinned host buffers
and device buffers for one batch's navigation and search queries, and pinned
host buffers for that batch's results. `upload` fills the pinned buffers
from the caller's arrays and copies them to the card on a copy stream of its
own; the compute stream (the current stream) waits for that copy's event
only, so the copy of batch i+1 runs beside the kernels of batch i.
`download` queues the copies of a batch's results into pinned buffers behind
its kernels and records an event; the returned function waits for that event
alone, not for the device.

Which stream touches what: every device tensor is allocated on the compute
stream. The copy stream only writes the slot's device query buffers; they are
marked as used by it (`record_stream`), and before its first write into a
newly allocated buffer the copy stream waits for the compute stream, whose
queued kernels may still read the memory in its former life. A slot is
reused ``n_slots`` batches later; the caller keeps fewer than ``n_slots``
batches in flight, so the slot's last batch has been fetched by then, and
`upload` still waits for that batch's events before it refills the pinned
buffers and overwrites the device buffers.
"""

import numpy as np
import torch

from tpulmi_torch.utils.profiling import span


class QueryStager:
    def __init__(self, device, n_slots: int):
        self.device = torch.device(device)
        self.copy_stream = torch.cuda.Stream(self.device)
        self.slots = [{} for _ in range(n_slots)]
        self.turn = 0

    def _buffers(self, slot: dict, name: str, shape):
        """The slot's (pinned, device) float32 buffers of `shape`."""
        pair = slot.get(name)
        if pair is None or pair[0].shape != torch.Size(shape):
            pinned = torch.empty(shape, dtype=torch.float32, pin_memory=True)
            dev = torch.empty(shape, dtype=torch.float32, device=self.device)
            dev.record_stream(self.copy_stream)
            self.copy_stream.wait_stream(
                torch.cuda.current_stream(self.device))
            pair = slot[name] = (pinned, dev)
        return pair

    def _to_card(self, slot: dict, name: str, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            # the caller's own tensor: nothing to stage or to recycle
            return x.to(self.device, torch.float32)
        x = np.asarray(x)
        pinned, dev = self._buffers(slot, name, x.shape)
        np.copyto(pinned.numpy(), x, casting="same_kind")
        with torch.cuda.stream(self.copy_stream):
            dev.copy_(pinned, non_blocking=True)
        return dev

    def upload(self, queries_nav, queries_search):
        """Start the copy of one batch to the card. Returns (navigation
        queries, search queries, slot); work queued on the current stream
        from here on runs after the copy."""
        slot = self.slots[self.turn % len(self.slots)]
        self.turn += 1
        for event in ("copied", "done"):
            if event in slot:
                # both have long happened (see the module docstring): the
                # pinned buffers are free to refill, the device buffers
                # free to overwrite
                slot[event].synchronize()
        qn = self._to_card(slot, "nav", queries_nav)
        qs = (qn if queries_search is queries_nav
              else self._to_card(slot, "search", queries_search))
        slot["copied"] = torch.cuda.Event()
        slot["copied"].record(self.copy_stream)
        torch.cuda.current_stream(self.device).wait_event(slot["copied"])
        return qn, qs, slot

    def download(self, slot: dict, out, skip_dists: bool = False):
        """Queue the copies of a search program's result (dists, ids,
        max_slots[, worklist total]) into the slot's pinned buffers behind
        the kernels that produce it. Returns a function that waits for
        those copies and gives the result as `LearnedIndex._fetch_result`
        does; with `skip_dists` the distances stay on the card."""
        dists, ids, *counts = out
        arrays = {"ids": ids}
        if not skip_dists:
            arrays["dists"] = dists
        arrays["counts"] = torch.stack([c.reshape(()) for c in counts])
        held = {}
        for name, t in arrays.items():
            buf = slot.get("out_" + name)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = slot["out_" + name] = torch.empty(
                    t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            held[name] = buf
        slot["done"] = torch.cuda.Event()
        slot["done"].record(torch.cuda.current_stream(self.device))
        done = slot["done"]

        def fetch():
            with span("search.fetch"):
                done.synchronize()
                # copies: the slot's buffers are refilled by a later batch
                return (None if skip_dists
                        else held["dists"].float().numpy().copy(),
                        held["ids"].numpy().copy(),
                        *(int(c) for c in held["counts"]))

        return fetch
