"""One fine-tuning step of the port's GAN trainer against the JAX
package's, on the CPU (tiny generator, initial channel 16; MPD / MSD at full
width; segment 1600, B=2): a batch that carries its own input mel (the
predicted mels of hifi-gan/meldataset.py:142-160), at the covomix recipe's
mel weight 45. Learning rate 0, so that the G step of both sides sees the
same discriminators: AdamW's first update moves a leaf by ~lr sign(g), and
the sign of a near-zero gradient is rounding noise. The losses are held
here; the gradients in tests/test_torch_gan_step.py (the discriminators'
weight gradients cross leaky-ReLU kinks on this near-DC y_hat, where one
flipped pre-activation moves them by ~1 % on either side)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from covomix_tpu.audio.mel import MelConfig as JMel, mel_spectrogram as jmel
from covomix_tpu.train import gan as JG
from covomix_tpu_torch.audio.mel import MelConfig as PMel
from covomix_tpu_torch.checkpoint import io as pio
from covomix_tpu_torch.train import gan as PG

from _torch_port import J_VOC, P_VOC, jax_gan_state, numpy_tree, torch_threads

SEG = 1600
LOSS_RTOL = 1e-5


def audio(seed, scale=0.1):
    return (np.random.RandomState(seed).randn(2, SEG) * scale).astype(np.float32)


def test_finetuning_step_matches_jax():
    """The generator reads the batch's mel; the mel-L1 target comes from the
    audio; the five losses equal the JAX step's."""
    st = PG.init_gan_state(torch.Generator().manual_seed(0), P_VOC, PG.GanConfig(segment_size=SEG))
    trees = tuple(numpy_tree(t) for t in (st.gen_params, st.mpd_params, st.msd_params))
    cfg_j = JG.GanConfig(segment_size=SEG, learning_rate=0.0)
    cfg_p = PG.GanConfig(segment_size=SEG, learning_rate=0.0)
    y = audio(8)
    mel = np.ascontiguousarray(np.asarray(jmel(jnp.asarray(audio(9)), JMel())).transpose(0, 2, 1))
    js = jax.device_get(jax_gan_state(*trees, cfg_j))
    js1, jm = JG.make_gan_step(J_VOC, JMel(), JMel(), cfg_j)(js, {"audio": jnp.asarray(y), "mel": jnp.asarray(mel)})
    ps = pio.params_from_numpy(js, "cpu", gan_cfg=cfg_p)
    step = PG.make_gan_step(P_VOC, PMel(), PMel(), cfg_p)
    batch = {"audio": torch.from_numpy(y), "mel": torch.from_numpy(mel)}
    _, mel_in, target = step.inputs(batch)
    assert mel_in is batch["mel"]
    np.testing.assert_allclose(target.numpy(), np.asarray(jmel(jnp.asarray(y), JMel())).transpose(0, 2, 1),
                               rtol=1e-5, atol=1e-5)
    with torch_threads(4):
        pm = step(ps, batch)
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
    assert ps.step == int(js1.step) == 1
