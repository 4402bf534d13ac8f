"""paddle.nn.functional (counterpart of ``paddle_tpu/nn/functional``).

Every function takes surface ``Tensor``s (the op runs through
``core.dispatch.run_op``: AMP cast, NaN check, a ``Tensor`` out) or raw
``torch.Tensor``s (the same torch body, a raw tensor out, no cast), so
the port's models keep calling these on torch tensors.
"""
from .activation import (celu, elu, elu_, gelu, glu, gumbel_softmax,
                         hardshrink, hardsigmoid, hardswish, hardtanh,
                         hardtanh_, leaky_relu, leaky_relu_, log_sigmoid,
                         log_softmax, maxout, mish, prelu, relu, relu6,
                         relu_, rrelu, selu, sigmoid, silu, softmax,
                         softmax_, softplus, softshrink, softsign, swiglu,
                         swish, tanh, tanh_, tanhshrink, thresholded_relu,
                         thresholded_relu_)
from .attention import (_mask_to_key_bands, _sdpa_core,
                        document_startend_row_indices, flash_attention,
                        flash_attn, flash_attn_qkvpacked,
                        flash_attn_unpadded, flash_attn_varlen_qkvpacked,
                        flashmask_attention, memory_efficient_attention,
                        scaled_dot_product_attention, sequence_mask)
from .common import (affine_grid, alpha_dropout, bicubic_interp, bilinear,
                     bilinear_interp, channel_shuffle, class_center_sample,
                     cosine_similarity, dropout, dropout2d, dropout3d,
                     embedding, feature_alpha_dropout, fold,
                     fused_softmax_mask, fused_softmax_mask_upper_triangle,
                     gather_tree, grid_sample, interpolate, label_smooth,
                     linear, linear_interp, nearest_interp, one_hot, pad,
                     pad3d, pairwise_distance, pixel_shuffle,
                     pixel_unshuffle, sparse_attention, temporal_shift,
                     trilinear_interp, unfold, upsample, zeropad2d)
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv2d_transpose_bias, conv3d, conv3d_transpose,
                   depthwise_conv2d, depthwise_conv2d_transpose)
from .loss import (adaptive_log_softmax_with_loss, bce_loss,
                   binary_cross_entropy, binary_cross_entropy_with_logits,
                   cosine_embedding_loss, cross_entropy,
                   cross_entropy_with_softmax, ctc_loss, dice_loss,
                   gaussian_nll_loss, hinge_embedding_loss, hinge_loss,
                   hsigmoid_loss, huber_loss, identity_loss, kl_div,
                   kldiv_loss, l1_loss, log_loss, margin_cross_entropy,
                   margin_ranking_loss, mse_loss,
                   multi_label_soft_margin_loss, multi_margin_loss,
                   nll_loss, npair_loss, poisson_nll_loss, rnnt_loss,
                   sigmoid_cross_entropy_with_logits, sigmoid_focal_loss,
                   smooth_l1_loss, soft_margin_loss,
                   softmax_with_cross_entropy, square_error_cost,
                   triplet_margin_loss, triplet_margin_with_distance_loss)
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,
                   local_response_norm, normalize, rms_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, fractional_max_pool2d,
                      fractional_max_pool3d, lp_pool1d, lp_pool2d,
                      max_pool1d, max_pool2d, max_pool3d, max_unpool1d,
                      max_unpool2d, max_unpool3d)
