"""CLI surface tests: reference flag compatibility + divergence policy."""

import os

import numpy as np
import pytest

from lz77_tpu import cli, spec

from conftest import CORPUS_SMALL


def run_cli(argv):
    return cli.main(argv)


def test_roundtrip_via_cli(tmp_path, rng):
    data = CORPUS_SMALL["text"](rng)
    inp, comp, out = tmp_path / "in", tmp_path / "comp", tmp_path / "out"
    inp.write_bytes(data)
    assert run_cli(["-c", "-i", str(inp), "-o", str(comp),
                    "-s", "255", "--block-size", "1024"]) == 0
    assert run_cli(["-d", "-i", str(comp), "-o", str(out)]) == 0
    assert out.read_bytes() == data


def test_numpy_backend_roundtrip(tmp_path, rng):
    data = CORPUS_SMALL["runs"](rng)[:500]
    inp, comp, out = tmp_path / "in", tmp_path / "comp", tmp_path / "out"
    inp.write_bytes(data)
    assert run_cli(["-c", "-i", str(inp), "-o", str(comp),
                    "--backend", "numpy"]) == 0
    assert run_cli(["-d", "-i", str(comp), "-o", str(out),
                    "--backend", "numpy"]) == 0
    assert out.read_bytes() == data


def test_validation_errors(tmp_path, capsys):
    f = tmp_path / "f"
    f.write_bytes(b"x")
    # bad la (main.c:101-107)
    assert run_cli(["-c", "-i", str(f), "-o", str(f) + ".o", "-l", "1"]) == 1
    assert run_cli(["-c", "-i", str(f), "-o", str(f) + ".o", "-l", "256"]) == 1
    # bad sb (main.c:109-115)
    assert run_cli(["-c", "-i", str(f), "-o", str(f) + ".o", "-s", "65536"]) == 1
    # duplicate input/output (main.c:82-95)
    assert run_cli(["-c", "-i", str(f), "-i", str(f), "-o", "x"]) == 1
    assert run_cli(["-c", "-i", str(f), "-o", "x", "-o", "y"]) == 1
    # missing files / mode (main.c:132-139, 163-166)
    assert run_cli(["-c", "-o", "x"]) == 1
    assert run_cli(["-c", "-i", str(f)]) == 1
    assert run_cli(["-i", str(f), "-o", "x"]) == 1


def test_degenerate_sb_rejected_by_default(tmp_path):
    f = tmp_path / "f"
    f.write_bytes(b"hello hello hello")
    out = str(tmp_path / "o")
    for sb in ("0", "1", "1024", "4096"):
        assert run_cli(["-c", "-i", str(f), "-o", out, "-s", sb]) == 1


def test_degenerate_sb_forced_is_safe(tmp_path):
    """--force-sb encodes power-of-two sb safely (reference corrupts)."""
    data = b"ababab" * 200
    inp, comp, out = tmp_path / "in", tmp_path / "comp", tmp_path / "out"
    inp.write_bytes(data)
    assert run_cli(["-c", "-i", str(inp), "-o", str(comp), "-s", "4",
                    "--force-sb", "--backend", "numpy"]) == 0
    assert run_cli(["-d", "-i", str(comp), "-o", str(out),
                    "--backend", "numpy"]) == 0
    assert out.read_bytes() == data
    # sb=0 is rejected even with --force-sb (bitof(0) is UB in the format).
    assert run_cli(["-c", "-i", str(inp), "-o", str(comp), "-s", "0",
                    "--force-sb"]) == 1


def test_report_flag(tmp_path, capsys, rng):
    data = CORPUS_SMALL["text"](rng)[:800]
    inp, comp = tmp_path / "in", tmp_path / "comp"
    inp.write_bytes(data)
    assert run_cli(["-c", "-i", str(inp), "-o", str(comp), "-s", "255",
                    "--report", "--block-size", "512"]) == 0
    err = capsys.readouterr().err
    import json

    rep = json.loads(err.strip().splitlines()[-1])
    assert rep["mode"] == "encode"
    assert rep["input_bytes"] == len(data)


def test_decode_backend_flag(tmp_path, capsys, rng):
    """--decode-backend selects the decoder; the backend actually used is
    recorded in --report."""
    import json

    data = CORPUS_SMALL["text"](rng)[:2000]
    inp, comp = tmp_path / "in", tmp_path / "comp"
    inp.write_bytes(data)
    assert run_cli(["-c", "-i", str(inp), "-o", str(comp)]) == 0
    for be, expect in (
        ("native", {"native", "native-streamed"}),
        ("host", {"host"}),
        ("device", {"device-xla-streamed"}),
    ):
        out = tmp_path / f"out.{be}"
        assert run_cli(["-d", "-i", str(comp), "-o", str(out),
                        "--decode-backend", be, "--report"]) == 0
        assert out.read_bytes() == data
        rep = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
        assert rep["decode_backend"] in expect


def test_dump_tool(tmp_path):
    """python -m lz77_tpu.dump: token-level stream inspection (both modes)."""
    import io
    import json as json_mod

    from lz77_tpu import dump as dump_mod
    from lz77_tpu.models import spec_np

    data = b"abcabcabcabc!"
    stream = spec_np.encode(data, None)
    f = tmp_path / "s.lz"
    f.write_bytes(stream)

    assert dump_mod.main([str(f), "--limit", "2"]) == 0
    out = io.StringIO()
    dump_mod.dump(stream, as_json=True, out=out)
    info = json_mod.loads(out.getvalue())
    assert info["sb"] == 4095 and info["la"] == 15
    assert info["decoded_bytes"] == len(data)
    assert info["literals"] + info["matches"] == info["tokens"]

    assert dump_mod.main([str(tmp_path / "missing.lz")]) == 1
    bad = tmp_path / "bad.lz"
    bad.write_bytes(b"\x01")
    assert dump_mod.main([str(bad)]) == 1


def test_cli_large_la_with_bitplane_matcher(tmp_path, capsys):
    """-l 64 --matcher bitplane runs the bit-plane matcher past the old
    la <= 33 cap."""
    inp = tmp_path / "in"
    out = tmp_path / "out"
    dec = tmp_path / "dec"
    data = b"abcabcabcabc" * 300
    inp.write_bytes(data)
    rc = cli.main(["-c", "-i", str(inp), "-o", str(out), "-l", "64",
                   "--matcher", "bitplane", "--block-size", "8192"])
    capsys.readouterr()
    assert rc == 0
    rc = cli.main(["-d", "-i", str(out), "-o", str(dec)])
    assert rc == 0
    assert dec.read_bytes() == data


def test_cli_fused_pipeline(tmp_path, capsys):
    inp = tmp_path / "in"
    out = tmp_path / "out"
    out2 = tmp_path / "out2"
    data = b"fused pipeline cli test " * 500
    inp.write_bytes(data)
    rc = cli.main(["-c", "-i", str(inp), "-o", str(out), "--pipeline",
                   "fused", "--matcher", "chunked", "--block-size", "4096",
                   "--report"])
    cap = capsys.readouterr()
    assert rc == 0
    assert '"pipeline": "fused"' in cap.err
    rc = cli.main(["-c", "-i", str(inp), "-o", str(out2), "--matcher",
                   "chunked", "--block-size", "4096"])
    assert rc == 0
    assert out.read_bytes() == out2.read_bytes()


def test_cli_sharded_pipeline(tmp_path, capsys):
    """--pipeline sharded over an explicit --mesh produces the exact same
    stream as the host pipeline (the multi-chip path is a product surface,
    not a test fixture)."""
    inp = tmp_path / "in"
    out = tmp_path / "out"
    out2 = tmp_path / "out2"
    data = b"sharded pipeline cli test " * 800
    inp.write_bytes(data)
    rc = cli.main(["-c", "-i", str(inp), "-o", str(out), "--pipeline",
                   "sharded", "--mesh", "4x2", "--matcher", "brute",
                   "--block-size", "1024", "--report"])
    cap = capsys.readouterr()
    assert rc == 0
    assert '"pipeline": "sharded"' in cap.err
    rc = cli.main(["-c", "-i", str(inp), "-o", str(out2), "--matcher",
                   "chunked", "--block-size", "1024", "--batch-blocks", "8"])
    assert rc == 0
    assert out.read_bytes() == out2.read_bytes()


def test_cli_sharded_bad_mesh(tmp_path, capsys):
    inp = tmp_path / "in"
    inp.write_bytes(b"x" * 100)
    rc = cli.main(["-c", "-i", str(inp), "-o", str(tmp_path / "o"),
                   "--pipeline", "sharded", "--mesh", "banana"])
    cap = capsys.readouterr()
    assert rc == 1
    assert "--mesh" in cap.err


def test_cli_host_devices_subprocess(tmp_path, rng):
    """--host-devices N runs the multi-device sharded pipeline on virtual
    CPU devices: the real CLI in a subprocess WITHOUT this suite's
    cpu/8-device env overrides."""
    import subprocess
    import sys

    data = CORPUS_SMALL["text"](rng)[:20000]
    inp, out = tmp_path / "in", tmp_path / "out.lz"
    inp.write_bytes(data)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    res = subprocess.run(
        [sys.executable, "-m", "lz77_tpu.cli", "-c", "-i", str(inp),
         "-o", str(out), "--pipeline", "sharded", "--mesh", "4x2",
         "--host-devices", "8", "--block-size", "2048",
         "--batch-blocks", "8", "--matcher", "bitplane"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=dict(env, JAX_ENABLE_COMPILATION_CACHE="false"),
    )
    assert res.returncode == 0, res.stderr[-2000:]
    from lz77_tpu import native
    from lz77_tpu.models import codec

    assert out.read_bytes() == codec.encode_bytes(
        data, spec.Params(), block_size=2048, batch_blocks=8
    )
    assert native.decode(out.read_bytes()) == data


def test_cli_edge_inputs_streamed_route(tmp_path):
    """Empty and 1-byte inputs through the streamed file encode/decode
    route: empty -> 4-byte header-only stream (SURVEY.md §2.3.1), both
    roundtrip bit-exact."""
    for data in (b"", b"Z"):
        ip = tmp_path / f"in{len(data)}"
        op = tmp_path / f"out{len(data)}.lz"
        dp = tmp_path / f"dec{len(data)}"
        ip.write_bytes(data)
        assert run_cli(["-c", "-i", str(ip), "-o", str(op)]) == 0
        assert run_cli(["-d", "-i", str(op), "-o", str(dp)]) == 0
        assert dp.read_bytes() == data
    assert (tmp_path / "out0.lz").stat().st_size == 4


def test_platform_flag_choices():
    """--platform takes cpu or gpu and refuses any other platform."""
    parser = cli.build_parser()
    for plat in ("cpu", "gpu"):
        assert parser.parse_args(
            ["-c", "-i", "x", "-o", "y", "--platform", plat]
        ).platform == plat
    with pytest.raises(SystemExit):
        parser.parse_args(["-c", "-i", "x", "-o", "y", "--platform", "tpu"])


def test_report_names_the_device(tmp_path, capsys):
    """--report carries platform and device_kind from jax.devices()[0], on
    encode and on device decode, so a CPU run cannot pass for a card run."""
    import json

    inp, comp, out = tmp_path / "in", tmp_path / "comp", tmp_path / "out"
    inp.write_bytes(b"report me " * 300)
    capsys.readouterr()
    assert run_cli(["-c", "-i", str(inp), "-o", str(comp), "--pipeline",
                    "fused", "--block-size", "2048", "--report"]) == 0
    assert run_cli(["-d", "-i", str(comp), "-o", str(out),
                    "--decode-backend", "device", "--report"]) == 0
    assert out.read_bytes() == inp.read_bytes()
    lines = capsys.readouterr().err.strip().splitlines()
    for line in (lines[0], lines[-1]):
        rep = json.loads(line)
        assert rep["platform"] == "cpu"
        assert rep["device_kind"]
        assert rep["device_count"] == 8
