"""The RNN-Transducer model around the losses (``transducer``): the
encoder, the prediction network, the joint network through which a model
reaches the fused losses, the loss functions and the train steps; and its
greedy and beam-search decoders (``decoding``)."""
from .decoding import (beam_search_decode, beam_search_decode_multiblank, beam_search_decode_tdt,
                       greedy_decode, greedy_decode_tdt)
from .transducer import (ConformerBlock, ConvModule, Encoder, FeedForward, Joint, LSTMCell,
                         MultiHeadAttention, Prediction, Transducer, TransducerConfig, loss_fn,
                         make_fused_train_step, make_multiblank_fused_train_step,
                         make_multiblank_train_step, make_pruned_fused_train_step,
                         make_pruned_train_step, make_tdt_fused_train_step, make_tdt_train_step,
                         make_train_step, multiblank_loss_fn, pruned_fused_loss_fn, pruned_loss_fn,
                         tdt_loss_fn)

__all__ = [
    "ConformerBlock", "ConvModule", "Encoder", "FeedForward", "Joint", "LSTMCell",
    "MultiHeadAttention", "Prediction", "Transducer", "TransducerConfig", "loss_fn",
    "make_fused_train_step", "make_multiblank_fused_train_step", "make_multiblank_train_step",
    "make_pruned_fused_train_step", "make_pruned_train_step", "make_tdt_fused_train_step",
    "make_tdt_train_step", "make_train_step", "multiblank_loss_fn", "pruned_fused_loss_fn",
    "pruned_loss_fn", "tdt_loss_fn",
    "beam_search_decode", "beam_search_decode_multiblank", "beam_search_decode_tdt",
    "greedy_decode", "greedy_decode_tdt",
]
