"""paddle.nn.layer (counterpart of ``paddle_tpu/nn/layer``): the eager
surface's Layers."""
from .activation import (CELU, ELU, GELU, GLU, SELU, Hardshrink, Hardsigmoid,
                         Hardswish, Hardtanh, LeakyReLU, LogSigmoid,
                         LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, RReLU,
                         Sigmoid, Silu, Softmax, Softplus, Softshrink,
                         Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU)
from .common import (AlphaDropout, Bilinear, ChannelShuffle,
                     CosineSimilarity, Dropout, Dropout2D, Dropout3D,
                     Embedding, FeatureAlphaDropout, Flatten, Fold, Identity,
                     Linear, Pad1D, Pad2D, Pad3D, PairwiseDistance,
                     PixelShuffle, PixelUnshuffle, Softmax2D, Unflatten,
                     Unfold, Upsample, UpsamplingBilinear2D,
                     UpsamplingNearest2D, ZeroPad1D, ZeroPad2D, ZeroPad3D)
from .container import (LayerDict, LayerList, ParameterDict, ParameterList,
                        Sequential)
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
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
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                      AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                      AvgPool1D, AvgPool2D, AvgPool3D, FractionalMaxPool2D,
                      FractionalMaxPool3D, LPPool1D, LPPool2D, MaxPool1D,
                      MaxPool2D, MaxPool3D, MaxUnPool1D, MaxUnPool2D,
                      MaxUnPool3D)
from .rnn import (GRU, LSTM, RNN, BeamSearchDecoder, BiRNN, GRUCell, LSTMCell,
                  RNNBase, RNNCellBase, SimpleRNN, SimpleRNNCell,
                  dynamic_decode)
