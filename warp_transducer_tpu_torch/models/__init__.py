"""Model parts around the losses. So far the joint network only
(``transducer.Joint``), through which a model reaches the fused losses."""
from .transducer import Joint, TransducerConfig

__all__ = ["Joint", "TransducerConfig"]
