"""The model zoo, ported from byteps_tpu/models/: the same leaf names,
shapes and layouts, so that a JAX worker and a torch worker declare the
same PS keys."""

from . import bert, llama, mlp, moe, resnet, vgg

__all__ = ["bert", "llama", "mlp", "moe", "resnet", "vgg"]
