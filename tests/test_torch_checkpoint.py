"""Chunked renders, checkpoint and resume (izpi_tpu_torch.render.checkpoint
and render()'s chunks), as tests/test_checkpoint.py holds the JAX package.

A chunk renders samples [off, off + n) and adds its float32 sum to a
float64 accumulator. The megakernel's plain version lays each chunk's
samples out anew (its replicas follow the chunk's sample count), so a
chunked render sums every pixel's samples in another order than one pass:
images within 2e-5 (the JAX test's bound), rays equal. The pool keeps
every sample's path, so its chunked images agree to the same bound.
"""

import numpy as np
import pytest

from izpi_tpu_torch.integrator import path as tpath
from izpi_tpu_torch.io import output as toutput
from izpi_tpu_torch.render import checkpoint as ck
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene.compiler import compile_scene
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.cornell_spectral import cornell_box_spectral

S = tpath.RenderSettings(max_depth=4)
ATOL = 2e-5


def _render(scene=None, spp=8, seed=9, **kw):
    return renderer.render(scene or cornell_box(), 12, 12, spp, S, seed=seed,
                           device="cpu", **kw)


def _spy(monkeypatch):
    """Record every state render() checkpoints, by samples done."""
    states = {}
    save = ck.save

    def spy(path, acc, done, rays, fp):
        states[done] = (acc.copy(), rays)
        save(path, acc, done, rays, fp)

    monkeypatch.setattr(ck, "save", spy)
    return states


@pytest.mark.parametrize("mode", ["wavefront", "pool"])
def test_resume_equals_uninterrupted(tmp_path, monkeypatch, mode):
    """Render 8 samples in chunks of 4, keep the 4-sample state, write it
    back as the checkpoint and resume: the image equals the uninterrupted
    one-pass render's, rays too."""
    full = _render(mode=mode)
    path = str(tmp_path / "r.npz")
    states = _spy(monkeypatch)
    chunked = _render(mode=mode, checkpoint_path=path, checkpoint_interval=4)
    assert sorted(states) == [4, 8]
    np.testing.assert_allclose(chunked.image, full.image, atol=ATOL)
    assert chunked.rays_traced == full.rays_traced

    _, meta = compile_scene(cornell_box(), "cpu")
    fp = ck.config_fingerprint(12, 12, 8, 9, meta, S)
    acc4, rays4 = states[4]
    ck.save(path, acc4, 4, rays4, fp)
    states.clear()
    resumed = _render(mode=mode, checkpoint_path=path, checkpoint_interval=4)
    assert sorted(states) == [8]          # only the second chunk ran
    np.testing.assert_allclose(resumed.image, full.image, atol=ATOL)
    assert resumed.rays_traced == full.rays_traced


def test_spectral_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """The spectral Cornell box: the checkpoint holds XYZ before firefly
    rejection, so the resumed XYZ and ACEScg equal one pass's."""
    scene = cornell_box_spectral
    full = _render(scene(), spp=4)
    path = str(tmp_path / "s.npz")
    states = _spy(monkeypatch)
    _render(scene(), spp=4, checkpoint_path=path, checkpoint_interval=2)
    _, meta = compile_scene(scene(), "cpu")
    fp = ck.config_fingerprint(12, 12, 4, 9, meta, S, "spectral")
    acc2, rays2 = states[2]
    ck.save(path, acc2, 2, rays2, fp)
    resumed = _render(scene(), spp=4, checkpoint_path=path,
                      checkpoint_interval=2)
    assert resumed.rays_traced == full.rays_traced
    np.testing.assert_allclose(resumed.xyz, full.xyz, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(resumed.image, full.image, atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("mode", ["wavefront", "pool", "simple"])
def test_chunked_equals_single_pass(mode, capsys):
    """verbose splits 8 samples into 8 chunks (renderer.py:363-368) and
    prints each; a preview does likewise; "simple" splits rows instead
    (row_chunk): each equals the one-pass render."""
    one = _render(mode=mode)
    if mode == "simple":
        chunked = _render(mode=mode, row_chunk=5, verbose=True)
        assert "rows 10..12 done" in capsys.readouterr().out
    else:
        chunked = _render(mode=mode, verbose=True)
        out = capsys.readouterr().out
        assert out.count("samples ") == 8 and "phases:" in out
        assert set(chunked.phases) == {"scene_build", "first_chunk", "render"}
    assert chunked.rays_traced == one.rays_traced
    np.testing.assert_allclose(chunked.image, one.image, atol=ATOL)


def test_preview_is_written(tmp_path):
    """A preview PNG of the image so far after every chunk; the last one
    is the final image's PNG."""
    path = str(tmp_path / "p.png")
    res = _render(spp=4, preview_path=path)
    final = str(tmp_path / "final.png")
    toutput.write_png(final, res.image)
    np.testing.assert_array_equal(toutput.read_image(path),
                                  toutput.read_image(final))


def test_fingerprint_mismatch_does_not_resume(tmp_path, monkeypatch):
    """A checkpoint of another configuration (seed 9) is not resumed by a
    render of seed 10: it renders every sample and overwrites the file."""
    path = str(tmp_path / "m.npz")
    _render(checkpoint_path=path, checkpoint_interval=4)
    states = _spy(monkeypatch)
    other = _render(seed=10, checkpoint_path=path, checkpoint_interval=4)
    assert sorted(states) == [4, 8]
    np.testing.assert_allclose(other.image, _render(seed=10).image, atol=ATOL)
    _, meta = compile_scene(cornell_box(), "cpu")
    assert ck.load(path, ck.config_fingerprint(12, 12, 8, 9, meta, S)) is None
    assert ck.load(path, ck.config_fingerprint(12, 12, 8, 10, meta,
                                               S)) is not None
    assert ck.load(str(tmp_path / "absent.npz"), "0" * 16) is None


def test_checkpoint_format(tmp_path):
    """The file holds acc as (n, 3) float64, samples_done and rays as
    int64 and the fingerprint's bytes; save refuses any other acc, and load
    raises on a file whose acc is not float64."""
    path = str(tmp_path / "f.npz")
    _render(spp=2, checkpoint_path=path, checkpoint_interval=1)
    with np.load(path) as z:
        assert z["acc"].dtype == np.float64 and z["acc"].shape == (144, 3)
        assert z["samples_done"].dtype == np.int64 and int(z["samples_done"]) == 2
        assert z["rays"].dtype == np.int64
        fp = z["fingerprint"].tobytes().decode()
    assert len(fp) == 16
    with pytest.raises(ValueError, match="float64"):
        ck.save(path, np.zeros((144, 3), np.float32), 1, 1, fp)
    np.savez(path, acc=np.zeros((144, 3), np.float32), samples_done=1,
             rays=1, fingerprint=np.frombuffer(fp.encode(), np.uint8))
    with pytest.raises(ValueError, match="float64"):
        ck.load(path, fp)
