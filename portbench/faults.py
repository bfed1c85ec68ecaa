"""Faults that a cell's timed path can have, each planted in the program
through `patch(owner, name, value)` (pytest's monkeypatch.setattr in the
CPU tests, calibrate's on the card): a run with one of them has to come
out not correct. The exchange between chips has no fault to plant: every
cell runs on one chip.
"""

from __future__ import annotations

import torch


def alter_one_answer(patch) -> None:
    """One score of each request's reply moved by 0.05."""
    import tfssd_torch.models.decoder as decoder

    original = decoder.decode_predictions

    def altered(*args, **kwargs):
        res = original(*args, **kwargs)
        scores = res.scores.clone()
        scores[0, 0] += 0.05
        return res._replace(scores=scores)

    patch(decoder, "decode_predictions", altered)


def leave_out_half(patch) -> None:
    """The second half of each request's images answered with zeros."""
    import tfssd_torch.models.decoder as decoder
    from tfssd_torch.ops.nms import NMSResult

    original = decoder.decode_predictions

    def half(anchors, deltas, logits, config):
        b = deltas.shape[0] // 2
        res = original(anchors, deltas[:b], logits[:b], config)
        return NMSResult(*(torch.cat([t, torch.zeros_like(t)])
                           for t in res))

    patch(decoder, "decode_predictions", half)


def stale_reply(patch) -> None:
    """Each reply is the previous request's."""
    import tfssd_torch.models.decoder as decoder

    original = decoder.decode_predictions
    last = []

    def stale(*args, **kwargs):
        last.append(original(*args, **kwargs))
        del last[:-2]
        return last[0]

    patch(decoder, "decode_predictions", stale)


def state_unchanged(patch) -> None:
    """A train step that counts itself but leaves the state as it was."""
    import tfssd_torch.train as port_train

    def no_update(state):
        state.step += 1

    patch(port_train, "apply_gradients", no_update)


def train_on_half(patch) -> None:
    """Each train step on the first half of its rows, the loss's mean over
    them."""
    import tfssd_torch.train as port_train

    original = port_train.gather_rows

    def half(data, idx):
        return original(data, idx[: len(idx) // 2])

    patch(port_train, "gather_rows", half)


SERVE = {"alter-one-answer": alter_one_answer,
         "leave-out-half": leave_out_half, "stale-reply": stale_reply}
TRAIN = {"state-unchanged": state_unchanged, "train-on-half": train_on_half}
FAULTS = {**SERVE, **TRAIN}
