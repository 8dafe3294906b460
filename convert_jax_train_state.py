"""Convert a JAX run's train-state checkpoint into the PyTorch port's.

train.py and hifigan_train.py save their state per step as an orbax
directory `<ckpt_dir>/step_XXXXXXXX/` (covomix_tpu/checkpoint/io.py); the
port resumes from `step_XXXXXXXX/state.npz` (covomix_tpu_torch/checkpoint/
io.py). This script restores the orbax tree and writes the port's file:

    python convert_jax_train_state.py <ckpt_dir>/step_00001000            # state.npz into that directory
    python convert_jax_train_state.py <ckpt_dir>/step_00001000 --out <port_ckpt_dir>   # <port_ckpt_dir>/step_00001000/

Every train state of the JAX package converts: a train.loop.TrainState
(canonical, or a --pp run's {'stacked', 'rest'} parameters), a --bmuf_sync
run's stacked {'train', 'bmuf'} state (every worker's row, the port's
stacked layout), and a train.gan.GanState. The tree is restored without an
abstract state, so orbax hands back nested dicts and lists (a NamedTuple as
a dict of its fields, a tuple as a list, an empty optax state as None);
`covomix_tpu_torch.checkpoint.io.train_state_from_numpy` rebuilds the state
from that tree's own keys and shapes, so no model config is needed. Then
`python -m covomix_tpu_torch.train --resume` (or hifigan_train) continues at
the next step from the directory holding the converted step.

Needs jax and orbax (it runs where the JAX package runs); the port itself
reads only the `.npz`."""

import argparse
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def convert(step_dir: str, out_dir: str = None) -> str:
    """Convert one JAX step directory; returns the path of the state.npz
    written (in `out_dir`/step_XXXXXXXX/, default the step directory)."""
    import jax
    import numpy as np

    from covomix_tpu.checkpoint import io as jio
    from covomix_tpu_torch.checkpoint import io as pio

    step_dir = os.path.abspath(step_dir.rstrip("/"))
    m = re.fullmatch(r"step_(\d+)", os.path.basename(step_dir))
    if m is None:
        raise ValueError(f"{step_dir}: not a step_XXXXXXXX directory")
    step = int(m.group(1))
    tree = jio.load_train_state(os.path.dirname(step_dir), step)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    state = pio.train_state_from_numpy(tree, "cpu")
    target = os.path.abspath(out_dir) if out_dir else os.path.dirname(step_dir)
    if target == os.path.dirname(step_dir):
        # beside orbax's own files: write the npz alone into the step directory
        path = os.path.join(step_dir, pio.STATE_FILE)
        np.savez(path, **pio.state_arrays(state))
        return path
    pio.save_train_state(target, state, step)
    return os.path.join(target, os.path.basename(step_dir), pio.STATE_FILE)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("step_dir", help="a JAX run's <ckpt_dir>/step_XXXXXXXX orbax directory")
    p.add_argument("--out", default=None, help="the port's checkpoint directory (default: beside orbax's files)")
    args = p.parse_args(argv)
    print(f"wrote {convert(args.step_dir, args.out)}")


if __name__ == "__main__":
    main()
