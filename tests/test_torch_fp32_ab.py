"""The ablations of ``tf_operator_tpu_torch/testing/fp32_flash_ab.py`` still
find their text in the kernel sources: the script raises at run time on the
card when one does not, after the timed runs of both trees. Reads files and
builds nothing."""

from pathlib import Path

import pytest

from tf_operator_tpu_torch.testing.fp32_flash_ab import ABLATIONS

CSRC = Path(__file__).resolve().parents[1] / "tf_operator_tpu_torch" / "ops" / "csrc"


@pytest.mark.parametrize("name", sorted(ABLATIONS))
def test_ablation_finds_its_text(name):
    """Each edit's text is in its file once, and the edit changes it."""
    for fname, old, new in ABLATIONS[name]:
        text = (CSRC / fname).read_text()
        assert text.count(old) == 1, (name, fname, old)
        assert old != new
