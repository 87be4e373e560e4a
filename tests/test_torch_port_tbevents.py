"""The port's TensorBoard event writer (`utils/tensorboard.py`, no
tensorboardX, tensorboard or protobuf) against tensorboardX's
``SummaryWriter``, the JAX trainers' writer: the same ``add_scalar`` and
``add_image`` calls through both, both files read back by tensorboard's
``EventFileLoader``.  Tags, steps and float32 values must be equal, and
the decoded PNG pixels equal exactly (both are tensorboardX's uint8
pixels of the same arrays); the file's first record is its
``file_version``, and a flipped byte fails the record's CRC.
"""

import glob
import io
import os
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from isosurfacesuperresolution_tpu_torch.utils import tensorboard as tb


def panel(rng, c, h, w):
    """A float CHW panel in [0, 1], as the trainers' `panel` makes them."""
    return np.clip(rng.rand(c, h, w).astype(np.float32) * 1.1 - 0.05,
                   0.0, 1.0)


def calls(rng):
    """The writer calls of an epoch of the unshaded trainer, and a few
    edge cases (a tag tensorboardX cleans, step 0, a one-channel image,
    odd sizes, a uint8 image, a non-finite scalar)."""
    out = []
    for epoch in (0, 1, 7):
        for tag, v in (("train/total_loss", 0.1234567 + epoch),
                       ("train/lr", 1e-4 * 0.5 ** epoch),
                       ("test/psnr", 23.5 - epoch),
                       ("/lead slash", -3.0), ("odd tag!", np.inf)):
            out.append(("scalar", tag, np.float32(v) if epoch else v, epoch))
        out.append(("image", "test/shaded", panel(rng, 3, 12, 36), epoch))
        out.append(("image", "test/depth", panel(rng, 1, 12, 36), epoch))
    out.append(("image", "odd", panel(rng, 3, 5, 7), 2))
    out.append(("image", "u8", (rng.rand(3, 4, 6) * 255).astype(np.uint8),
                3))
    return out


def write(writer, log):
    for c in log:
        getattr(writer, f"add_{c[0]}")(*c[1:])
    writer.close()


def read_events(path):
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader)
    out = []
    for ev in EventFileLoader(path).Load():
        if ev.file_version:
            out.append(("file_version", ev.file_version))
        for v in ev.summary.value:
            if v.HasField("image"):
                im = v.image
                px = np.asarray(Image.open(io.BytesIO(
                    im.encoded_image_string)))
                out.append(("image", v.tag, ev.step, im.height, im.width,
                            im.colorspace, px))
            else:
                out.append(("scalar", v.tag, ev.step,
                            np.float32(v.simple_value)))
    return out


def one_file(d):
    files = glob.glob(os.path.join(d, "events.out.tfevents.*"))
    assert len(files) == 1, files
    return files[0]


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    from tensorboardX import SummaryWriter
    log = calls(np.random.RandomState(0))
    jdir = str(tmp_path_factory.mktemp("tbx"))
    pdir = str(tmp_path_factory.mktemp("port"))
    write(SummaryWriter(jdir), log)
    write(tb.EventWriter(pdir), log)
    return one_file(jdir), one_file(pdir)


def test_events_equal_tensorboardx(logs):
    want, got = (read_events(p) for p in logs)
    assert len(got) == len(want) == 1 + 5 * 3 + 2 * 3 + 2
    for w, g in zip(want, got):
        if g[0] == "image":
            assert g[:6] == w[:6]
            assert g[6].dtype == w[6].dtype == np.uint8
            np.testing.assert_array_equal(g[6], w[6], err_msg=g[1])
        elif g[0] == "scalar":
            assert g[:3] == w[:3]
            assert g[3] == w[3] or (np.isnan(g[3]) and np.isnan(w[3]))
        else:
            assert g == w


def test_file_name_and_version_record(logs):
    _, path = logs
    name = os.path.basename(path).split(".")
    assert name[:3] == ["events", "out", "tfevents"]
    assert len(name[3]) == 10 and name[3].isdigit()
    assert read_events(path)[0] == ("file_version", tb.FILE_VERSION)
    assert read_events(path)[0][1] == "brain.Event:2"


def test_flipped_byte_fails_the_crc(logs, tmp_path):
    """Every part of a record is covered: a flip in the second record's
    length, event data or data trailer fails tensorboard's record reader
    with a CRC data-loss error, and its event loader stops before that
    record (after the file_version record)."""
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader)
    from tensorboard.compat.tensorflow_stub import errors
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import (
        PyRecordReader_New)
    _, path = logs
    raw = Path(path).read_bytes()
    second = 8 + 4 + int.from_bytes(raw[:8], "little") + 4
    size = 8 + 4 + int.from_bytes(raw[second:second + 8], "little") + 4
    for at in (second + 2, second + 20, second + size - 1):
        bad = bytearray(raw)
        bad[at] ^= 0x10
        p = tmp_path / f"events.out.tfevents.0000000000.flip{at}"
        p.write_bytes(bytes(bad))
        p = str(p)
        reader = PyRecordReader_New(p)
        reader.GetNext()
        with pytest.raises(errors.DataLossError, match="crc32"):
            reader.GetNext()
        events = list(EventFileLoader(p).Load())
        assert [e.file_version for e in events] == [tb.FILE_VERSION]


def test_record_framing_matches_known_crcs():
    """The masked CRC-32C of TFRecord (the CRC-32C check value of
    "123456789" is 0xe3069283) and a framed empty record."""
    from isosurfacesuperresolution_tpu_torch.train.ocdbt import crc32c
    assert crc32c(b"123456789") == 0xE3069283
    c = 0xE3069283
    assert tb.masked_crc(b"123456789") == (
        ((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF
    rec = tb.frame_record(b"")
    assert len(rec) == 16 and rec[:8] == bytes(8)
