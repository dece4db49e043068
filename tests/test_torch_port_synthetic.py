"""The port's synthetic digits where the DejaVu fonts are missing (on the
CPU): Pillow's scalable face at the requested size stands in, so the
digits keep their size; with the fonts present, the digits are the JAX
package's bit for bit."""
import numpy as np
import pytest

from ratio_guided_multimodal_fm_tpu.data import synthetic as jsyn
from ratio_guided_multimodal_fm_tpu_torch.data import synthetic as psyn


def _ink(images):
    """Pixels above half intensity, per image."""
    return (images.astype(np.float32) > 128).reshape(len(images), -1).sum(1)


@pytest.mark.parametrize("kind", ["mnist", "svhn"])
def test_digits_equal_jax_where_the_fonts_exist(kind):
    a = psyn.generate_digits(kind, 12, 3, cache=False)
    b = jsyn.generate_digits(kind, 12, 3, cache=False)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_digits_keep_their_size_without_dejavu(monkeypatch):
    """Without the font files the fallback face draws digits of about the
    same ink as DejaVu's (58 pixels above half intensity on average here;
    Pillow's 10-px default, the JAX module's fallback, draws 0.1)."""
    with_fonts, _ = psyn.generate_digits("mnist", 64, 5, cache=False)
    monkeypatch.setattr(psyn, "_FONT_PATHS", ["/nonexistent/font.ttf"])
    monkeypatch.setattr(psyn, "_FONT_CACHE", {})
    without, labels = psyn.generate_digits("mnist", 64, 5, cache=False)
    ratio = _ink(without).mean() / _ink(with_fonts).mean()
    assert 0.5 < ratio < 2.0, ratio
    assert set(labels) == set(range(10))
