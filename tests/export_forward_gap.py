"""How far two float32 forwards of one fine-tuned checkpoint lie apart, and
from a float64 forward: the port's EfficientLab against the JAX
package's, on the checkpoint that tests/test_torch_exports.py's CLI run
fine-tunes (ASPP + skip decoding, 32^2), for each `--seed`:

    JAX_PLATFORMS=cpu python tests/export_forward_gap.py --seeds 0 1

On the CPU, a few seconds a seed. Prints, per seed, the largest
|port - JAX|, |port - float64| and |JAX - float64| over the test's
probabilities (two uniform-noise images, eval mode). The float64 forward
is the port's module in float64 from the same float32 weights.
"""
import argparse
import glob
import os
import shlex
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mliis_tpu.meta.inner_loop import ModelState as JModelState  # noqa
from mliis_tpu.meta.inner_loop import OptimizerConfig as JOptimizerConfig
from mliis_tpu.meta.inner_loop import init_opt_state as jinit_opt  # noqa
from mliis_tpu.models.efficientlab import EfficientLab as JaxEfficientLab
from mliis_tpu_torch.cli import args as targs  # noqa: E402
from mliis_tpu_torch.cli import run_metasegnet as trun  # noqa: E402
from mliis_tpu_torch.meta import inner_loop as til  # noqa: E402
from mliis_tpu_torch.models.efficientlab import EfficientLab  # noqa: E402
from mliis_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from tests.test_torch_decoders import nested  # noqa: E402
from tests.test_torch_exports import CLI, SIZE  # noqa: E402


def gaps(seed, workdir):
    argv = shlex.split(CLI) + ["--seed", str(seed), "--checkpoint",
                               os.path.join(workdir, "ckpt"),
                               "--save_fine_tuned_checkpoints_dir",
                               os.path.join(workdir, "ft")]
    state = trun.main(argv, device="cpu")
    args = targs.argument_parser().parse_args(argv)
    path = glob.glob(os.path.join(workdir, "ft", "synthetic_rect_0000", "0",
                                  "*.npz"))[0]
    tuned, _ = tckpt.restore_checkpoint(path, state)
    model = EfficientLab(**targs.model_kwargs(args))
    til.load_state(model, tuned)
    flat = tckpt.params_to_jax(model)
    params = nested(flat, "params/")
    jstate = JModelState(params, nested(flat, "batch_stats/"),
                         jinit_opt(params, JOptimizerConfig("sgd")))
    images = np.random.default_rng(3).uniform(
        0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    jmodel = JaxEfficientLab(**targs.model_kwargs(args))
    (_, jprob), _ = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False, mutable=["batch_stats"]))(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        jnp.asarray(images))
    jprob = np.asarray(jprob)
    with torch.no_grad():
        p32 = model(torch.from_numpy(images), train=False)[1].numpy()
        p64 = model.double()(torch.from_numpy(images).double(),
                             train=False)[1].numpy()
    return (float(np.abs(p32 - jprob).max()), float(np.abs(p32 - p64).max()),
            float(np.abs(jprob - p64).max()))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    for seed in parser.parse_args().seeds:
        with tempfile.TemporaryDirectory() as workdir:
            port_jax, port_f64, jax_f64 = gaps(seed, workdir)
        print("seed {}: |port - JAX| {:.4g}, |port - float64| {:.4g}, "
              "|JAX - float64| {:.4g}".format(seed, port_jax, port_f64,
                                                jax_f64), flush=True)


if __name__ == "__main__":
    main()
