"""MetricsLogger's TensorBoard scalars (tfssd_torch/utils/metrics.py,
utils/tfevents.py), written without TensorFlow, read by tensorboard.

- tensorboard's EventAccumulator reads every logged scalar back: its tag
  (the prefixed name), step, wall time and float32 value equal the JSONL
  line's.
- Each record parsed with tensorboard's own Event protobuf: the first holds
  file_version "brain.Event:2", each other one Summary.Value with the
  "scalars" plugin, DATA_CLASS_SCALAR and a rank-0 DT_FLOAT tensor, as
  tf.summary.scalar writes it; the TFRecord CRCs equal google_crc32c's.
- One file per logger, named events.out.tfevents.<secs>.<host>.<pid>.<n>.v2;
  a second logger in the same directory and second takes the next <n>;
  tensorboard=False writes none; a write that fails raises.
"""

import json
import os
import re
import socket
import struct

import numpy as np
import pytest

pytest.importorskip("tensorboard")
crc32c = pytest.importorskip("google_crc32c")

from tensorboard.backend.event_processing import (  # noqa: E402
    event_accumulator, event_file_loader)
from tensorboard.compat.proto import event_pb2, summary_pb2  # noqa: E402
from tensorboard.compat.proto import types_pb2  # noqa: E402
from tensorboard.util import tensor_util  # noqa: E402

from tfssd_torch.utils import tfevents  # noqa: E402
from tfssd_torch.utils.metrics import MetricsLogger  # noqa: E402

STEPS = {0: {"loss": 12.5, "grad_norm": 101.0896987915039},
         1: {"loss": 3.25e-7, "grad_norm": -0.0},
         7: {"loss": float(np.float32(1) / 3), "grad_norm": 1e30}}


def _log(log_dir):
    with MetricsLogger(str(log_dir)) as log:
        for step, scalars in STEPS.items():
            log.log(step, scalars, prefix="train/")
        log.log(9, {"val_loss": 2.0, "epoch": 0})
        events = log.events_path
    with open(log_dir / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    return events, lines


def _masked(data: bytes) -> bytes:
    crc = crc32c.value(data)
    return struct.pack("<I", ((crc >> 15 | crc << 17) + 0xA282EAD8)
                       & 0xFFFFFFFF)


def test_tensorboard_reads_every_scalar_as_the_jsonl(tmp_path):
    events, lines = _log(tmp_path)
    assert [p for p in os.listdir(tmp_path) if "tfevents" in p] == [
        os.path.basename(events)]
    acc = event_accumulator.EventAccumulator(str(tmp_path))
    acc.Reload()
    want = {}
    for line in lines:
        for tag, value in line.items():
            if tag not in ("step", "time"):
                want.setdefault(tag, []).append(
                    (line["step"], line["time"], np.float32(value)))
    assert sorted(acc.Tags()["tensors"]) == sorted(want)
    for tag, rows in want.items():
        got = [(e.step, e.wall_time,
                tensor_util.make_ndarray(e.tensor_proto))
               for e in acc.Tensors(tag)]
        assert [(s, t) for s, t, _ in got] == [(s, t) for s, t, _ in rows]
        for (_, _, g), (_, _, w) in zip(got, rows):
            assert g.shape == () and g.dtype == np.float32
            assert g.tobytes() == w.tobytes(), (tag, g, w)


def test_records_are_what_tf_summary_scalar_writes(tmp_path):
    events, lines = _log(tmp_path)
    name = os.path.basename(events)
    assert re.fullmatch(
        rf"events\.out\.tfevents\.\d{{10}}\.{re.escape(socket.gethostname())}"
        rf"\.{os.getpid()}\.0\.v2", name), name
    data = open(events, "rb").read()
    records, pos = [], 0
    while pos < len(data):
        n = struct.unpack("<Q", data[pos:pos + 8])[0]
        assert data[pos + 8:pos + 12] == _masked(data[pos:pos + 8])
        body = data[pos + 12:pos + 12 + n]
        assert data[pos + 12 + n:pos + 16 + n] == _masked(body)
        records.append(event_pb2.Event.FromString(body))
        pos += 16 + n
    assert records == list(event_file_loader.EventFileLoader(events).Load())
    first, rest = records[0], records[1:]
    assert first.file_version == "brain.Event:2" and first.wall_time > 0
    assert len(rest) == sum(len(line) - 2 for line in lines)
    for event in rest:
        assert len(event.summary.value) == 1
        value = event.summary.value[0]
        assert value.metadata.plugin_data.plugin_name == "scalars"
        assert value.metadata.data_class == summary_pb2.DATA_CLASS_SCALAR
        assert value.tensor.dtype == types_pb2.DT_FLOAT
        assert len(value.tensor.tensor_shape.dim) == 0
        assert value.WhichOneof("value") == "tensor"
    assert tfevents.read_scalars(events) == ("brain.Event:2", [
        (e.summary.value[0].tag, e.step,
         float(tensor_util.make_ndarray(e.summary.value[0].tensor)))
        for e in rest])


def test_file_per_logger_and_no_file_without_tensorboard(tmp_path):
    paths = []
    for _ in range(3):
        with MetricsLogger(str(tmp_path)) as log:
            paths.append(log.events_path)
    stems = {p.rsplit(".", 3)[0] for p in paths}
    assert len(set(paths)) == 3 and all(os.path.exists(p) for p in paths)
    if len(stems) == 1:  # the three fell in the same second
        assert [p.rsplit(".", 2)[1] for p in paths] == ["0", "1", "2"]
    other = tmp_path / "off"
    with MetricsLogger(str(other), tensorboard=False) as log:
        log.log(0, {"loss": 1.0})
        assert log.events_path is None
    assert os.listdir(other) == ["metrics.jsonl"]


def test_a_failed_write_raises(tmp_path):
    class Full:
        def write(self, data):
            raise OSError(28, "No space left on device")

        def flush(self):
            pass

        def close(self):
            pass

    log = MetricsLogger(str(tmp_path))
    log._tb._f.close()
    log._tb._f = Full()
    with pytest.raises(OSError, match="No space"):
        log.log(0, {"loss": 1.0})
    log.close()
