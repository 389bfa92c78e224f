"""fBRS predictors: base (transform pipeline), f-BRS-A/B/C feature
refinement for both backbones, and input BRS (RGB-BRS / DistMap-BRS).

Counterpart of xmem2_tpu/interactive/fbrs/predictor.py. Parity targets:
fbrs/inference/predictors/base.py (BasePredictor), brs.py:54-141
(FeatureBRSPredictor, insertion after_c4/after_aspp/after_deeplab),
brs.py:143-226 (HRNetFeatureBRSPredictor, insertion A/C), brs.py:228-280
(InputBRSPredictor, optimize_target rgb/dmaps/all), brs_functors.py
(ScaleBiasOptimizer/InputOptimizer with early-exit rules, scale_act,
flip_average), brs_losses.py (BRSMaskLoss), and predictors/__init__.py:8-95
(mode dispatch, L-BFGS m=20 factr=0 pgtol=1e-8 maxfun=20, net_clicks_limit 8
for f-BRS / 5 for input BRS).

scipy's fmin_l_bfgs_b drives the optimization on the host in float64; each
function evaluation is one torch autograd pass with respect to one float32
leaf, the opt vector, on the device, and one synchronised device-to-host
copy of (loss, the early-exit maxima, the mask's IoU terms, gradient). The
thresholded masks and the best logits stay on the device.
"""

import numpy as np
import torch

from xmem2_tpu_torch.interactive.clicks.dist_maps import (
    clicks_to_points, encode_dist, get_dist_maps_native)
from xmem2_tpu_torch.interactive.fbrs.hrnet import HRNetModel
from xmem2_tpu_torch.interactive.fbrs.transforms import (
    AddHorizontalFlip, LimitLongestSide, SigmoidForPred, ZoomIn)
from xmem2_tpu_torch.nn.functional import resize_bilinear

NORM_RADIUS = 260


def compute_coord_features(image, clicks_lists, norm_radius=NORM_RADIUS):
    """Per-batch-item BFS dist maps on the host -> [B, 2, H, W] on the
    image's device (cpu_dist_maps=True path, reference
    fbrs_controller.py:8)."""
    b, _, h, w = image.shape
    out = np.empty((b, 2, h, w), np.float32)
    for i, clicks in enumerate(clicks_lists):
        out[i] = get_dist_maps_native(clicks_to_points(clicks), h, w,
                                      norm_radius)
    return torch.from_numpy(encode_dist(out)).to(image.device)


class BasePredictor:
    """model: FBRSModel or HRNetModel on its device, weights in the compute
    dtype (controller.py builds it)."""

    def __init__(self, model, net_clicks_limit=None, with_flip=False,
                 zoom_in=None, max_size=None, **kwargs):
        self.model = model
        self.device = next(model.parameters()).device
        self.with_flip = with_flip
        self.net_clicks_limit = net_clicks_limit
        self.original_image = None
        self.zoom_in = zoom_in

        self.transforms = [zoom_in] if zoom_in is not None else []
        if max_size is not None:
            self.transforms.append(LimitLongestSide(max_size=max_size))
        self.transforms.append(SigmoidForPred())
        if with_flip:
            self.transforms.append(AddHorizontalFlip())

    def set_input_image(self, image):
        """image [H, W, 3] or [1, H, W, 3] float (ImageNet-normalized),
        tensor or array."""
        for t in self.transforms:
            t.reset()
        image = torch.as_tensor(image).to(self.device).float()
        if image.dim() == 3:
            image = image[None]
        self.original_image = image.permute(0, 3, 1, 2).contiguous()

    @torch.no_grad()
    def get_prediction(self, clicker):
        """-> probabilities [1, 1, H, W] on the device."""
        clicks_list = clicker.get_clicks()
        image, clicks_lists, is_image_changed = self.apply_transforms(
            self.original_image, [clicks_list])

        pred_logits = self._get_prediction(image, clicks_lists,
                                           is_image_changed)
        prediction = resize_bilinear(pred_logits, image.shape[-2:],
                                     align_corners=True)
        for t in reversed(self.transforms):
            prediction = t.inv_transform(prediction)

        if self.zoom_in is not None and \
                self.zoom_in.check_possible_recalculation():
            return self.get_prediction(clicker)
        return prediction

    def _get_prediction(self, image, clicks_lists, is_image_changed):
        coord = compute_coord_features(image, self._limited(clicks_lists))
        return self.model(image, coord)

    def _limited(self, clicks_lists):
        if self.net_clicks_limit is None:
            return clicks_lists
        return [cl[:self.net_clicks_limit] for cl in clicks_lists]

    def apply_transforms(self, image, clicks_lists):
        is_image_changed = False
        for t in self.transforms:
            image, clicks_lists = t.transform(image, clicks_lists)
            is_image_changed |= t.image_changed
        return image, clicks_lists, is_image_changed

    def get_states(self):
        return {'transform_states': [t.get_state() for t in self.transforms]}

    def set_states(self, states):
        for state, t in zip(states['transform_states'], self.transforms):
            t.set_state(state)


class BRSBasePredictor(BasePredictor):
    """Common BRS machinery: click maps, the BRS mask loss with early exits,
    and the scipy L-BFGS loop (reference BRSBasePredictor + BaseOptimizer,
    brs.py:10-52 + brs_functors.py:8-85)."""

    def __init__(self, model, optimize_after_n_clicks=1, prob_thresh=0.49,
                 reg_weight=1e-3, min_iou_diff=0.01, flip_average=False,
                 lbfgs_params=None, **kwargs):
        super().__init__(model, **kwargs)
        self.optimize_after_n_clicks = optimize_after_n_clicks
        self.prob_thresh = prob_thresh
        self.reg_weight = reg_weight
        self.min_iou_diff = min_iou_diff
        self.flip_average = flip_average
        self.lbfgs_params = {'m': 20, 'factr': 0, 'pgtol': 1e-8, 'maxfun': 20}
        if lbfgs_params:
            self.lbfgs_params.update(lbfgs_params)
        self.lbfgs_params['maxiter'] = 2 * self.lbfgs_params['maxfun']

        self.opt_data = None
        self.input_data = None
        # function evaluations of the last _optimize call
        self.last_evaluations = 0

    def set_input_image(self, image):
        super().set_input_image(image)
        self.opt_data = None
        self.input_data = None

    # -- subclass contract ---------------------------------------------------
    def _predict_with_opt(self, opt_params, input_data, out_hw):
        """(logits at out_hw, regularization loss) from the optimization
        variables; differentiable in opt_params."""
        raise NotImplementedError

    def _get_head_input(self, image, coord):
        raise NotImplementedError

    # -- loss (BRSMaskLoss + reg, brs_losses.py:6-26) -------------------------
    def _brs_loss(self, opt_params, input_data, pos_mask, neg_mask, out_hw):
        """-> (loss, (logits, max |pos diff|, max |neg diff|, result))."""
        logits, reg = self._predict_with_opt(opt_params, input_data, out_hw)
        result = torch.sigmoid(logits)
        if self.with_flip and self.flip_average:
            n = result.shape[0] // 2
            result = 0.5 * (result[:n] + result[n:].flip(-1))
            pos_mask, neg_mask = pos_mask[:n], neg_mask[:n]

        pos_diff = (1 - result) * pos_mask
        neg_diff = result * neg_mask
        eps = 1e-5
        loss = (torch.sum(pos_diff ** 2) / (torch.sum(pos_mask) + eps)
                + torch.sum(neg_diff ** 2) / (torch.sum(neg_mask) + eps))
        aux = (logits, pos_diff.abs().amax(), neg_diff.abs().amax(), result)
        return loss + reg, aux

    def _loss_and_grad(self, x, input_data, pos_mask, neg_mask, out_hw):
        """(loss, aux), gradient with respect to the float32 opt vector x."""
        with torch.enable_grad():
            opt = torch.as_tensor(x, dtype=torch.float32,
                                  device=self.device).requires_grad_(True)
            loss, aux = self._brs_loss(opt, input_data, pos_mask, neg_mask,
                                       out_hw)
            grad, = torch.autograd.grad(loss, opt)
        return (loss.detach(), tuple(a.detach() for a in aux)), grad

    def _clicks_maps(self, clicks_lists, shape, radius=1):
        h, w = shape
        pos = np.zeros((len(clicks_lists), 1, h, w), np.float32)
        neg = np.zeros((len(clicks_lists), 1, h, w), np.float32)
        for li, clicks in enumerate(clicks_lists):
            for c in clicks:
                y, x = int(round(c.coords[0])), int(round(c.coords[1]))
                y1, x1 = max(y - radius, 0), max(x - radius, 0)
                tgt = pos if c.is_positive else neg
                tgt[li, 0, y1:y + radius + 1, x1:x + radius + 1] = 1
        return (torch.from_numpy(pos).to(self.device),
                torch.from_numpy(neg).to(self.device))

    # -- the L-BFGS loop (BaseOptimizer.__call__, brs_functors.py:41-78) ----
    def _optimize(self, x0, input_data, pos_mask, neg_mask, out_hw,
                  num_clicks):
        from scipy.optimize import fmin_l_bfgs_b

        best = {'loss': None, 'logits': None}
        last_mask = {'m': None}
        self.last_evaluations = 0

        def func(x):
            self.last_evaluations += 1
            (loss, aux), grad = self._loss_and_grad(
                x.astype(np.float32), input_data, pos_mask, neg_mask, out_hw)
            logits, f_max_pos, f_max_neg, result = aux
            cur = result > self.prob_thresh
            prev = cur if last_mask['m'] is None else last_mask['m']
            inter = (cur & prev).sum()
            union = (cur | prev).sum()
            # the one synchronised copy of this evaluation
            host = torch.cat([torch.stack([loss, f_max_pos, f_max_neg,
                                           inter.float(), union.float()]),
                              grad.reshape(-1)]).cpu().numpy()
            f_val = float(host[0])
            if best['loss'] is None or f_val < best['loss']:
                best['loss'] = f_val
                best['logits'] = logits
            # early exits (brs_functors.py:63-73)
            if host[1] < (1 - self.prob_thresh) and host[2] < self.prob_thresh:
                return f_val, np.zeros_like(x)
            if last_mask['m'] is not None and self.min_iou_diff > 0:
                if host[4] > 0 and host[3] / host[4] > 1 - self.min_iou_diff:
                    return f_val, np.zeros_like(x)
            last_mask['m'] = cur
            return f_val, host[5:].astype(np.float64)

        opt_vec = None
        if num_clicks > self.optimize_after_n_clicks:
            result = fmin_l_bfgs_b(func=func, x0=x0.astype(np.float64),
                                   m=self.lbfgs_params['m'],
                                   factr=self.lbfgs_params['factr'],
                                   pgtol=self.lbfgs_params['pgtol'],
                                   maxfun=self.lbfgs_params['maxfun'],
                                   maxiter=self.lbfgs_params['maxiter'])
            opt_vec = result[0].astype(np.float32)

        if best['logits'] is not None:
            return best['logits'], opt_vec
        with torch.no_grad():
            opt = torch.from_numpy(np.asarray(x0, np.float32)).to(self.device)
            logits, _ = self._predict_with_opt(opt, input_data, out_hw)
        return logits, opt_vec

    def get_states(self):
        return {'transform_states': [t.get_state() for t in self.transforms],
                'opt_data': None if self.opt_data is None
                else self.opt_data.copy()}

    def set_states(self, states):
        for state, t in zip(states['transform_states'], self.transforms):
            t.set_state(state)
        self.opt_data = states['opt_data']


class ScaleBiasBRSPredictor(BRSBasePredictor):
    """Shared scale/bias BRS flow for both backbones (reference
    FeatureBRSPredictor/HRNetFeatureBRSPredictor bodies are line-for-line
    parallel, brs.py:54-226; the differences are the insertion points)."""

    def __init__(self, model, scale_act=None, reg_bias_weight=10.0, **kwargs):
        super().__init__(model, **kwargs)
        self.scale_act = scale_act
        self.reg_bias_weight = reg_bias_weight
        self.num_channels = None   # set by subclass

    def _unpack_scale_bias(self, opt_params):
        """ScaleBiasOptimizer.unpack_opt_params (brs_functors.py:96-109)."""
        c = self.num_channels
        scale = opt_params[:c]
        bias = opt_params[c:]
        reg = self.reg_weight * (torch.sum(scale ** 2)
                                 + self.reg_bias_weight * torch.sum(bias ** 2))
        if self.scale_act == 'tanh':
            scale = torch.tanh(scale)
        elif self.scale_act == 'sin':
            scale = torch.sin(scale)
        return 1.0 + scale, bias, reg

    def _scaled(self, opt_params, feats):
        scale, bias, reg = self._unpack_scale_bias(opt_params)
        return feats * scale[None, :, None, None] + bias[None, :, None, None], \
            reg

    def _get_prediction(self, image, clicks_lists, is_image_changed):
        num_clicks = len(clicks_lists[0])
        pos_mask, neg_mask = self._clicks_maps(clicks_lists, image.shape[-2:])

        if self.opt_data is None:
            self.opt_data = np.zeros((2 * self.num_channels,), np.float32)

        if (num_clicks <= (self.net_clicks_limit or num_clicks)
                or is_image_changed or self.input_data is None):
            coord = compute_coord_features(image, self._limited(clicks_lists))
            self.input_data = self._get_head_input(image, coord)

        logits, opt_vec = self._optimize(
            self.opt_data, self.input_data, pos_mask, neg_mask,
            tuple(image.shape[-2:]), num_clicks)
        if opt_vec is not None:
            self.opt_data = opt_vec
        return logits


class FeatureBRSPredictor(ScaleBiasBRSPredictor):
    """f-BRS on the DeepLabV3+ backbone (reference brs.py:54-141):
      after_c4 (f-BRS-A) / after_aspp (f-BRS-B) / after_deeplab (f-BRS-C)."""

    def __init__(self, model, insertion_mode='after_deeplab', **kwargs):
        super().__init__(model, **kwargs)
        self.insertion_mode = insertion_mode
        ch = model.num_channels
        if insertion_mode == 'after_deeplab':
            self.num_channels = ch
        elif insertion_mode == 'after_c4':
            self.num_channels = model.num_c4_channels
        elif insertion_mode == 'after_aspp':
            self.num_channels = ch + 32
        else:
            raise NotImplementedError(insertion_mode)

    @torch.no_grad()
    def _get_head_input(self, image, coord):
        """reference _get_head_input (brs.py:121-141). A dict, so the
        after_c4 case carries the frozen c1 skip features alongside."""
        m = self.model
        x = m.rgb_with_clicks(image, coord)
        if self.insertion_mode == 'after_c4':
            c1, c4 = m.backbone_features(x)
            return {'feats': c4, 'c1': c1}
        feats = m.head_input(x)
        if self.insertion_mode == 'after_deeplab':
            feats = m.deeplab_head(feats)
        return {'feats': feats}

    def _predict_with_opt(self, opt_params, input_data, out_hw):
        m = self.model
        scaled, reg = self._scaled(opt_params, input_data['feats'])
        if self.insertion_mode == 'after_c4':
            x = m.deeplab_head(m.aspp_concat(scaled, input_data['c1']))
        elif self.insertion_mode == 'after_aspp':
            x = m.deeplab_head(scaled)
        else:
            x = scaled
        return m.logits_from_deeplab(x, out_hw), reg


class HRNetFeatureBRSPredictor(ScaleBiasBRSPredictor):
    """f-BRS on the HRNet+OCR backbone (reference brs.py:143-226):
      'A' scales the stitched HRNet features, 'C' the OCR output."""

    def __init__(self, model, insertion_mode='A', **kwargs):
        super().__init__(model, **kwargs)
        self.insertion_mode = insertion_mode
        fe = model.feature_extractor
        if insertion_mode == 'A':
            self.num_channels = fe.aux_head[0].in_channels
        elif insertion_mode == 'C':
            self.num_channels = fe.conv3x3_ocr[0].out_channels
        else:
            raise NotImplementedError(insertion_mode)

    @torch.no_grad()
    def _get_head_input(self, image, coord):
        """reference brs.py:209-226."""
        fe = self.model.feature_extractor
        feats = fe.compute_hrnet_feats(self.model.rgb_with_clicks(image, coord))
        if self.insertion_mode == 'C':
            feats, _ = fe.ocr(feats)
        return {'feats': feats}

    def _predict_with_opt(self, opt_params, input_data, out_hw):
        fe = self.model.feature_extractor
        scaled, reg = self._scaled(opt_params, input_data['feats'])
        if self.insertion_mode == 'A':
            scaled, _ = fe.ocr(scaled)
        logits = fe.cls_head(scaled)
        return resize_bilinear(logits.float(), out_hw, align_corners=True), \
            reg


class InputBRSPredictor(BRSBasePredictor):
    """RGB-BRS / DistMap-BRS: optimize an image-shaped bias on the network
    input (reference brs.py:228-280 + InputOptimizer brs_functors.py:88-96).
    optimize_target: 'rgb', 'dmaps', or 'all' (rgb_conv output)."""

    def __init__(self, model, optimize_target='rgb', **kwargs):
        super().__init__(model, **kwargs)
        self.optimize_target = optimize_target
        self.hrnet = isinstance(model, HRNetModel)
        self._opt_shape = None

    def _get_prediction(self, image, clicks_lists, is_image_changed):
        num_clicks = len(clicks_lists[0])
        pos_mask, neg_mask = self._clicks_maps(clicks_lists, image.shape[-2:])

        bs = image.shape[0] // 2 if self.with_flip else image.shape[0]
        opt_channels = 2 if self.optimize_target == 'dmaps' else 3
        shape = (bs, opt_channels, image.shape[2], image.shape[3])
        if self.opt_data is None or is_image_changed \
                or self._opt_shape != shape:
            self.opt_data = np.zeros(shape, np.float32).ravel()
            self._opt_shape = shape

        # dist maps depend only on click coords (constant w.r.t. the bias)
        coord = compute_coord_features(image, self._limited(clicks_lists))
        input_data = {'image': image.float(), 'dmaps': coord}

        logits, opt_vec = self._optimize(
            self.opt_data, input_data, pos_mask, neg_mask,
            tuple(image.shape[-2:]), num_clicks)
        if opt_vec is not None:
            self.opt_data = opt_vec
        return logits

    def _predict_with_opt(self, opt_params, input_data, out_hw):
        opt = opt_params.reshape(self._opt_shape)
        reg = self.reg_weight * torch.sum(opt ** 2)
        if self.with_flip:
            opt = torch.cat([opt, opt.flip(-1)], dim=0)

        image, dmaps = input_data['image'], input_data['dmaps']
        if self.optimize_target == 'rgb':
            image = image + opt
        if self.optimize_target == 'dmaps':
            dmaps = dmaps + opt

        m = self.model
        x = m.rgb_with_clicks(image, dmaps)
        if self.optimize_target == 'all':
            x = x + opt

        if self.hrnet:
            logits, _ = m.feature_extractor(x)
        else:
            feats = m.deeplab_head(m.head_input(x))
            logits = m.logits_from_deeplab(feats, x.shape[-2:])
        return resize_bilinear(logits.float(), out_hw, align_corners=True), \
            reg


def get_predictor(model, brs_mode='f-BRS-B', prob_thresh=0.49, with_flip=True,
                  zoom_in_params=None, predictor_params=None,
                  brs_opt_func_params=None, lbfgs_params=None):
    """Predictor factory (reference predictors/__init__.py:8-95)."""
    zoom_in = (ZoomIn(**zoom_in_params) if zoom_in_params is not None
               else ZoomIn())
    pp = dict(predictor_params or {})
    opt = dict(brs_opt_func_params or {})
    max_size = pp.pop('max_size', None)
    common = dict(with_flip=with_flip, zoom_in=zoom_in, max_size=max_size)

    if brs_mode == 'NoBRS':
        return BasePredictor(model, **common, **pp)

    brs_common = dict(prob_thresh=prob_thresh, lbfgs_params=lbfgs_params,
                      **common, **opt)

    if brs_mode.startswith('f-BRS'):
        insertion_mode = {
            'f-BRS-A': 'after_c4',
            'f-BRS-B': 'after_aspp',
            'f-BRS-C': 'after_deeplab',
        }[brs_mode]
        net_clicks_limit = pp.pop('net_clicks_limit', 8)
        if isinstance(model, HRNetModel):
            insertion_mode = {'after_c4': 'A', 'after_aspp': 'A',
                              'after_deeplab': 'C'}[insertion_mode]
            cls = HRNetFeatureBRSPredictor
        else:
            cls = FeatureBRSPredictor
        return cls(model, insertion_mode=insertion_mode,
                   net_clicks_limit=net_clicks_limit, **brs_common, **pp)

    if brs_mode in ('RGB-BRS', 'DistMap-BRS'):
        return InputBRSPredictor(
            model,
            optimize_target='dmaps' if brs_mode == 'DistMap-BRS' else 'rgb',
            net_clicks_limit=pp.pop('net_clicks_limit', 5),
            **brs_common, **pp)

    raise NotImplementedError(f'unknown brs_mode {brs_mode!r}')
