"""TensorBoard event-file writer: wire-format round trip (no TF dep)."""

import os
import struct

from ctc_asr.utils.tb_events import EventFileWriter, _masked_crc, crc32c


def _read_records(path):
    """Parse TFRecord framing, verifying both CRCs per record."""
    records = []
    with open(path, "rb") as fh:
        data = fh.read()
    off = 0
    while off < len(data):
        header = data[off:off + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[off + 8:off + 12])
        assert hcrc == _masked_crc(header), "header CRC mismatch"
        payload = data[off + 12:off + 12 + length]
        (pcrc,) = struct.unpack("<I",
                                data[off + 12 + length:off + 16 + length])
        assert pcrc == _masked_crc(payload), "payload CRC mismatch"
        records.append(payload)
        off += 16 + length
    return records


def _parse_proto(buf):
    """Flat {field_number: [values]} wire parse (no schema)."""
    fields = {}
    off = 0
    while off < len(buf):
        key = 0
        shift = 0
        while True:
            b = buf[off]
            off += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wt = key >> 3, key & 7
        if wt == 0:  # varint
            val = 0
            shift = 0
            while True:
                b = buf[off]
                off += 1
                val |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
        elif wt == 1:  # 64-bit
            (val,) = struct.unpack("<d", buf[off:off + 8])
            off += 8
        elif wt == 5:  # 32-bit
            (val,) = struct.unpack("<f", buf[off:off + 4])
            off += 4
        elif wt == 2:  # length-delimited
            ln = 0
            shift = 0
            while True:
                b = buf[off]
                off += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            val = buf[off:off + ln]
            off += ln
        else:
            raise AssertionError(f"wire type {wt}")
        fields.setdefault(field, []).append(val)
    return fields


def test_crc32c_known_vectors():
    # RFC 3720 / kernel test vectors
    assert crc32c(b"") == 0x0
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(bytes(32)) == 0x8A9136AA


def test_event_file_round_trip(tmp_path):
    w = EventFileWriter(str(tmp_path))
    w.add_scalars(3, {"loss": 2.5, "wer": 0.25, "note": "skip-me"})
    w.add_scalars(4, {"loss": 1.25})
    w.close()

    records = _read_records(w.path)
    assert len(records) == 3  # file_version + 2 scalar events

    ev0 = _parse_proto(records[0])
    assert ev0[3] == [b"brain.Event:2"]     # file_version

    ev1 = _parse_proto(records[1])
    assert ev1[2] == [3]                    # step
    summary = _parse_proto(ev1[5][0])
    tags = {}
    for value_msg in summary[1]:
        v = _parse_proto(value_msg)
        tags[v[1][0].decode()] = v[2][0]
    assert abs(tags["loss"] - 2.5) < 1e-6
    assert abs(tags["wer"] - 0.25) < 1e-6
    assert "note" not in tags               # non-numeric dropped

    ev2 = _parse_proto(records[2])
    assert ev2[2] == [4]


def test_metrics_writer_emits_tb_file(tmp_path):
    from ctc_asr.metrics import MetricsWriter
    mw = MetricsWriter(str(tmp_path), echo=False)
    mw.write(1, loss=3.0)
    mw.write(2, loss=2.0, wer=0.5)
    mw.close()
    tb_files = [f for f in os.listdir(tmp_path)
                if f.startswith("events.out.tfevents.")]
    assert len(tb_files) == 1
    recs = _read_records(os.path.join(tmp_path, tb_files[0]))
    assert len(recs) == 3
    # JSONL still written alongside
    assert os.path.exists(os.path.join(tmp_path, "metrics.jsonl"))
