"""The paper's own evaluation models (FedPSA §6.1 Network Architectures).

* MNIST: CNN — two 5x5 convs (32, 64 ch) each + ReLU + 2x2 maxpool, fc 512.
* FMNIST: single linear layer 784 -> 10, bias init 0.
* CIFAR-10/100: CNN — two 5x5 convs (64, 64) + fc 384 + fc 192.
* synthetic-mlp: the small model the synthetic-data benchmarks train.
"""
from repro_torch.models.config import ModelConfig

CONFIGS = {
    "paper-mnist-cnn": ModelConfig(
        name="paper-mnist-cnn", family="cnn",
        cnn_channels=(32, 64), cnn_kernel=5, mlp_hidden=(512,),
        input_hw=(28, 28, 1), num_classes=10,
    ),
    "paper-fmnist-linear": ModelConfig(
        name="paper-fmnist-linear", family="mlp",
        mlp_hidden=(), input_hw=(784, 0, 0), num_classes=10,
    ),
    "paper-cifar10-cnn": ModelConfig(
        name="paper-cifar10-cnn", family="cnn",
        cnn_channels=(64, 64), cnn_kernel=5, mlp_hidden=(384, 192),
        input_hw=(32, 32, 3), num_classes=10,
    ),
    "paper-cifar100-cnn": ModelConfig(
        name="paper-cifar100-cnn", family="cnn",
        cnn_channels=(64, 64), cnn_kernel=5, mlp_hidden=(384, 192),
        input_hw=(32, 32, 3), num_classes=100,
    ),
    "paper-synthetic-mlp": ModelConfig(
        name="paper-synthetic-mlp", family="mlp",
        mlp_hidden=(64, 32), input_hw=(32, 0, 0), num_classes=10,
    ),
}
