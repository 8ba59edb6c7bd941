"""``repro_torch.codecs`` - the composable coding API (the ported part of
``repro.codecs``)::

    blob = codecs.compress(codec, data, lanes=16, seed=0, device="cuda")
    data = codecs.decompress(codec, blob, device="cuda")
"""

from repro_torch.core.codec import Codec
from repro_torch.core.distributions import Bernoulli, Categorical
from repro_torch.codecs.leaves import (DiscretizedGaussian,
                                       DiscretizedLogistic, PointwiseCDF,
                                       Uniform)
from repro_torch.codecs.combinators import BBANS, Chained, Repeat, Serial, Shaped
from repro_torch.codecs.container import (ContainerError, blob_info,
                                          compress, decompress, fresh_stack)
from repro_torch.codecs.quantize import (FixedPointFn, LutBernoulli,
                                         QuantConfig, quantize_params)
from repro_torch.codecs.compile import CompiledCodec, compile

__all__ = [
    "Codec", "Bernoulli", "Categorical",
    "DiscretizedGaussian", "DiscretizedLogistic", "PointwiseCDF", "Uniform",
    "BBANS", "Chained", "Repeat", "Serial", "Shaped",
    "compile", "CompiledCodec",
    "FixedPointFn", "LutBernoulli", "QuantConfig", "quantize_params",
    "compress", "decompress", "blob_info", "fresh_stack", "ContainerError",
]
