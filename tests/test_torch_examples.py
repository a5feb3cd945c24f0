"""The port's examples (``python -m repro_torch.examples.<name>``), each
driven through its ``main(argv)`` on the CPU at a small size (each well
under 20 s here); the published sizes run on the card by default."""
import math
import os
import subprocess
import sys
from pathlib import Path


from repro_torch.examples import (
    delta_transformer_decode, quickstart, streaming_server,
    train_acoustic_model,
)

SRC = Path(__file__).resolve().parents[1] / "src"


def test_quickstart_runs_the_pipeline(capsys):
    out = quickstart.main(["--device", "cpu", "--hidden", "16", "--frames",
                           "32", "--steps-per-epoch", "1",
                           "--pretrain-epochs", "3", "--retrain-epochs", "1"])
    text = capsys.readouterr().out
    for section in ("== 1/2:", "== 3:", "== 4:", "modelled Spartus"):
        assert section in text
    assert math.isfinite(out["pretrain_loss"])
    assert math.isfinite(out["retrain_loss"])
    assert out["frames"] == 32
    assert 0.0 < out["temporal_sparsity"] < 1.0
    assert 0.0 <= out["weight_sparsity"] < 1.0 and out["op_saving"] >= 1.0


def test_train_acoustic_model_small(capsys, tmp_path):
    out = train_acoustic_model.main(
        ["--small", "--device", "cpu", "--steps-per-epoch", "2",
         "--pretrain-epochs", "2", "--retrain-epochs", "1", "--frames",
         "32"])
    text = capsys.readouterr().out
    assert "model: LSTM-2L-64H-UNI" in text and "layer1:" in text
    assert out["steps"] == 6
    assert math.isfinite(out["pretrain_loss"])
    assert math.isfinite(out["retrain_loss"])
    # --ckpt commits a checkpoint per epoch
    train_acoustic_model.main(
        ["--small", "--device", "cpu", "--steps-per-epoch", "1",
         "--pretrain-epochs", "2", "--retrain-epochs", "1", "--frames",
         "16", "--ckpt", str(tmp_path)])
    assert sorted(p.name for p in tmp_path.iterdir()
                  if (p / "COMMIT").exists())


def test_streaming_server_demo_holds_parity(capsys):
    out = streaming_server.main(["--device", "cpu", "--clients", "8",
                                 "--hidden", "16", "--frames", "24"])
    text = capsys.readouterr().out
    assert "parity with serve_requests at 1e-5: OK" in text
    assert out["clients"] == 8 and out["partial_blocks"] >= 8
    assert 0.0 < out["temporal_sparsity"] < 1.0


def test_delta_transformer_decode_sparsity_follows_the_signal(capsys):
    rows = delta_transformer_decode.main(["--device", "cpu", "--frames",
                                          "48", "--dim", "32", "--out-dim",
                                          "64"])
    assert "speech ts" in capsys.readouterr().out
    assert [r["theta"] for r in rows] == delta_transformer_decode.THETAS
    assert rows[0]["max_err"] <= 1e-4        # theta 0: the dense product
    speech = [r["speech_ts"] for r in rows]
    assert speech == sorted(speech) and speech[-1] > rows[-1]["text_ts"]


def test_examples_run_as_modules():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.delta_transformer_decode",
         "--device", "cpu", "--frames", "16", "--dim", "16", "--out-dim",
         "16"], env=dict(os.environ, PYTHONPATH=str(SRC)),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "theta | speech ts" in proc.stdout
