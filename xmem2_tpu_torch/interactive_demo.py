"""Interactive GUI bootstrap on the GPU.

    python -m xmem2_tpu_torch.interactive_demo --images DIR [--device cpu]

Counterpart of the root interactive_demo.py (reference
interactive_demo.py:27-99 surface), with the same flags plus --device:
loads the XMem (.pth or the JAX package's .npz), S2M and f-BRS checkpoints,
a workspace ResourceManager, and the Qt App. Runs on CUDA unless --device
cpu, and raises without a card. Requires PyQt5 (the engine and Python API
do not): without it, prints so and exits 1.
"""

import os
import sys
from argparse import ArgumentParser

from xmem2_tpu_torch.config import VIDEO_INFERENCE_CONFIG, resolve_device


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument('--model', default='./saves/XMem.npz')
    parser.add_argument('--s2m_model', default='saves/s2m.pth')
    parser.add_argument('--fbrs_model', default='saves/fbrs.pth')
    parser.add_argument('--images', help='Folder with input images', default=None)
    parser.add_argument('--video', help='Video file', default=None)
    parser.add_argument('--workspace',
                        help='Directory for memory-of-work (has priority over images/video)',
                        default=None)
    parser.add_argument('--buffer_size', type=int, default=100)
    parser.add_argument('--num_objects', type=int, default=None)
    parser.add_argument('--num_objects_default_value', type=int, default=1)
    parser.add_argument('--size', default=480, type=int,
                        help='Resize shorter side; -1 keeps original')
    parser.add_argument('--top_k', type=int, default=30)
    parser.add_argument('--mem_every', type=int, default=10)
    parser.add_argument('--deep_update_every', type=int, default=-1)
    parser.add_argument('--no_amp', action='store_true')
    parser.add_argument('--max_mid_term_frames', type=int, default=10)
    parser.add_argument('--min_mid_term_frames', type=int, default=5)
    parser.add_argument('--max_long_term_elements', type=int, default=10000)
    parser.add_argument('--num_prototypes', type=int, default=128)
    parser.add_argument('--device', default=None,
                        help='torch device; CUDA unless given (e.g. cpu)')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    try:
        from PyQt5.QtWidgets import QApplication
    except ImportError:
        print('PyQt5 is required for the GUI. The engine itself works without '
              'it: use process_video.py / the run_on_video API instead.')
        sys.exit(1)

    from xmem2_tpu_torch.bridge.torch_params import load_model
    from xmem2_tpu_torch.inference.core import InferenceCore
    from xmem2_tpu_torch.inference.net import XMemNet
    from xmem2_tpu_torch.interactive.fbrs.controller import FBRSController
    from xmem2_tpu_torch.interactive.gui import App
    from xmem2_tpu_torch.interactive.resource_manager import ResourceManager
    from xmem2_tpu_torch.interactive.s2m import (
        S2MController, load_s2m_state_dict)

    config = VIDEO_INFERENCE_CONFIG.copy()
    config.update({k: v for k, v in vars(args).items() if k != 'device'})
    config['enable_long_term'] = True
    config['enable_long_term_count_usage'] = True

    dtype = 'float32' if args.no_amp else 'auto'
    network = XMemNet(load_model(args.model, device), compute_dtype=dtype,
                      device=device)
    processor = InferenceCore(network, config=config, device=device)

    res_man = ResourceManager(config)

    s2m_ctrl = None
    if os.path.exists(args.s2m_model):
        s2m_ctrl = S2MController(load_s2m_state_dict(args.s2m_model),
                                 res_man.num_objects, ignore_class=255,
                                 compute_dtype=dtype, device=device)
    fbrs_ctrl = None
    if os.path.exists(args.fbrs_model):
        fbrs_ctrl = FBRSController(args.fbrs_model, compute_dtype=dtype,
                                   device=device)

    app = QApplication(sys.argv)
    ex = App(processor, res_man, s2m_ctrl, fbrs_ctrl, config)
    ex.show()
    sys.exit(app.exec_())


if __name__ == '__main__':
    main()
