"""The port's examples (`scoreperformer_tpu_torch/examples/`) on the CPU, at
their smallest settings: two streamed windows, and one training epoch then
a render. Each prints what the JAX package's example prints."""
import re

import pytest
import torch

from scoreperformer_tpu_torch.examples import interactive_streaming, train_render_lifecycle

torch.set_num_threads(1)


def test_interactive_streaming_streams_two_windows_on_the_cpu(tmp_path, capsys):
    interactive_streaming.main(["--device", "cpu", "--windows", "2", "--out", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    windows = [l for l in lines if l.startswith("window ")]
    assert [w.split(":")[0] for w in windows] == ["window 0", "window 1"]
    assert re.match(r"window 0: \[0\.0, 0\.5\) predicted~\d+ generated \d+", windows[0])
    total = sum(int(re.search(r"generated (\d+)", w).group(1)) for w in windows)
    assert total > 0
    assert lines[-1] == f"streamed {total} notes over 1.0s of score time"


def test_train_render_lifecycle_trains_an_epoch_and_renders_on_the_cpu(tmp_path, capsys):
    train_render_lifecycle.main(["--device", "cpu", "--epochs", "1", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    loss = re.search(r"trained 1 epochs: loss (\S+) -> (\S+)", out)
    assert loss and all(float(x) == float(x) for x in loss.groups())  # finite, not NaN
    rendered = re.search(r"rendered (\d+) notes: (\S+) -> (\S+)", out)
    assert rendered and int(rendered.group(1)) > 0
    assert (tmp_path / "rendered_performance.mid").stat().st_size > 0
    assert (tmp_path / "run" / "checkpoint_last" / "tokenizer.json").exists()


@pytest.mark.parametrize("example", [interactive_streaming, train_render_lifecycle], ids=lambda m: m.__name__)
def test_examples_run_on_the_card_by_default_and_raise_without_it(example, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        example.main(["--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # nothing written before the device check
