"""The port's model stack: the dense and vlm decoder-only families, with
prefill attention on the hand-written kernel K3; the moe family, with its
expert products on the hand-written kernel K5 (and its attention on K3);
the ssm family (rwkv6), with its prefill scan on the hand-written kernel
K4; the hybrid (hymba-1.5b), with its windowed attention on K3 beside a
Mamba branch in torch ops; the encoder-decoder, with its windowed encoder
on K3; and the models
of the paper's own evaluation (LSTM, KWT-1, ConvNet), which the federated
trainer trains."""
from .api import (SHAPES, build_model, input_specs, params_spec,
                  shape_for_long_context)
from .common import ModelConfig, cross_entropy_loss, rmsnorm
from .paper_models import ConvNet, KWTModel, LSTMModel
from .transformer import DecoderLM, EncDecLM

__all__ = ["ModelConfig", "cross_entropy_loss", "rmsnorm", "SHAPES",
           "build_model", "input_specs", "params_spec",
           "shape_for_long_context", "DecoderLM", "EncDecLM",
           "LSTMModel", "KWTModel", "ConvNet"]
