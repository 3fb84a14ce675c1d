"""Model zoo of the port (counterpart of ``bluefog_tpu/models``): the MNIST
CNN, ResNet for the benchmark, VGG, a small MLP, and the decoder
transformer of the long-context trainer; plus rope and the variables of a
flax model (:func:`variables_from_jax`, :func:`variables_to_jax`)."""
from .cnn import MnistCNN
from .layers import variables_from_jax, variables_to_jax
from .mlp import MLP
from .resnet import ResNet, ResNet18, ResNet34, ResNet50
from .rope import apply_rope, apply_rope_grid, apply_rope_rows
from .transformer import RingTransformerBlock, RingTransformerLM
from .vgg import VGG, VGG11, VGG16

__all__ = [
    "MLP", "MnistCNN",
    "ResNet", "ResNet18", "ResNet34", "ResNet50",
    "RingTransformerBlock", "RingTransformerLM",
    "VGG", "VGG11", "VGG16",
    "variables_from_jax", "variables_to_jax",
    "apply_rope", "apply_rope_grid", "apply_rope_rows",
]
