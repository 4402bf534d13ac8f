"""paddle.nn.layer (counterpart of ``paddle_tpu/nn/layer``): the eager
surface's Layers. conv, pooling and rnn come with later slices."""
from .activation import (CELU, ELU, GELU, GLU, SELU, Hardshrink, Hardsigmoid,
                         Hardswish, Hardtanh, LeakyReLU, LogSigmoid,
                         LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, RReLU,
                         Sigmoid, Silu, Softmax, Softplus, Softshrink,
                         Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU)
from .common import (AlphaDropout, Bilinear, CosineSimilarity, Dropout,
                     Dropout2D, Dropout3D, Embedding, FeatureAlphaDropout,
                     Flatten, Identity, Linear, Pad1D, Pad2D, Pad3D,
                     PairwiseDistance, Softmax2D, Unflatten, ZeroPad1D,
                     ZeroPad2D, ZeroPad3D)
from .container import (LayerDict, LayerList, ParameterDict, ParameterList,
                        Sequential)
from .layers import Layer
from .loss import (AdaptiveLogSoftmaxWithLoss, BCELoss, BCEWithLogitsLoss,
                   CosineEmbeddingLoss, CrossEntropyLoss, CTCLoss,
                   GaussianNLLLoss, HingeEmbeddingLoss, HSigmoidLoss,
                   KLDivLoss, L1Loss, MarginRankingLoss, MSELoss,
                   MultiLabelSoftMarginLoss, MultiMarginLoss, NLLLoss,
                   PoissonNLLLoss, RNNTLoss, SmoothL1Loss, SoftMarginLoss,
                   TripletMarginLoss, TripletMarginWithDistanceLoss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm1D, InstanceNorm2D,
                   InstanceNorm3D, LayerNorm, LocalResponseNorm, RMSNorm,
                   SpectralNorm, SyncBatchNorm)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
