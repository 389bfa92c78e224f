"""Training configuration (reference util/configuration.py:7-126 surface):
argparse with per-stage (s0..s3) hyperparameters and stage projection. A
copy of xmem2_tpu/train/configuration.py with the same stage defaults, plus
--device."""

from argparse import ArgumentParser


def none_or_default(x, default):
    return x if x is not None else default


class Configuration:
    def parse(self, unknown_arg_ok=False, argv=None):
        parser = ArgumentParser()

        parser.add_argument('--benchmark', action='store_true')
        parser.add_argument('--no_amp', action='store_true',
                            help='float32 without TF32 instead of bfloat16 '
                                 'autocast')
        parser.add_argument('--device', default=None,
                            help='cuda (the default) or cpu')

        # Data parameters
        parser.add_argument('--static_root', default='../Datasets/static')
        parser.add_argument('--bl_root', default='../Datasets/BL30K')
        parser.add_argument('--yv_root', default='../Datasets/YouTube')
        parser.add_argument('--davis_root', default='../Datasets/DAVIS')
        parser.add_argument('--num_workers', type=int, default=4,
                            help='dataloader worker threads per process')

        parser.add_argument('--key_dim', default=64, type=int)
        parser.add_argument('--value_dim', default=512, type=int)
        parser.add_argument('--hidden_dim', default=64, type=int,
                            help='Set to =0 to disable')
        parser.add_argument('--deep_update_prob', default=0.2, type=float)
        parser.add_argument('--crop_size', default=384, type=int,
                            help='training crop (the reference hardcodes 384)')
        parser.add_argument('--stages', default='02',
                            help='0-static images, 1-BL30K, 2/3-DAVIS+YouTubeVOS')

        stage_defaults = {
            '0': dict(batch_size=8, iterations=150000, finetune=0, steps=[],
                      lr=1e-5, num_ref_frames=2, num_frames=3,
                      start_warm=20000, end_warm=70000),
            '1': dict(batch_size=8, iterations=250000, finetune=0,
                      steps=[200000], lr=1e-5, num_ref_frames=3, num_frames=8,
                      start_warm=20000, end_warm=70000),
            '2': dict(batch_size=8, iterations=150000, finetune=10000,
                      steps=[120000], lr=1e-5, num_ref_frames=3, num_frames=8,
                      start_warm=20000, end_warm=70000),
            '3': dict(batch_size=8, iterations=100000, finetune=10000,
                      steps=[80000], lr=1e-5, num_ref_frames=3, num_frames=8,
                      start_warm=20000, end_warm=70000),
        }
        for s, d in stage_defaults.items():
            for k, v in d.items():
                if k == 'steps':
                    parser.add_argument(f'--s{s}_steps', nargs='*', default=v,
                                        type=int)
                else:
                    parser.add_argument(f'--s{s}_{k}', default=v, type=type(v))

        parser.add_argument('--gamma', default=0.1, type=float,
                            help='LR := LR*gamma at every decay step')
        parser.add_argument('--weight_decay', default=0.05, type=float)

        parser.add_argument('--load_network', help='Path to network weights only')
        parser.add_argument('--load_checkpoint',
                            help='Path to a full checkpoint (net+opt+it)')

        parser.add_argument('--log_text_interval', default=100, type=int)
        parser.add_argument('--log_image_interval', default=1000, type=int)
        parser.add_argument('--save_network_interval', default=25000, type=int)
        parser.add_argument('--save_checkpoint_interval', default=50000, type=int)
        parser.add_argument('--exp_id', default='NULL',
                            help='Experiment UNIQUE id; NULL disables tensorboard')
        parser.add_argument('--debug', action='store_true')
        parser.add_argument('--stats', metavar='PATH',
                            help='write per-stage step measurements as JSON '
                                 '(python -m xmem2_tpu_torch.train)')

        if unknown_arg_ok:
            args, _ = parser.parse_known_args(argv)
            self.args = vars(args)
        else:
            self.args = vars(parser.parse_args(argv))

        self.args['amp'] = not self.args['no_amp']

        for s in list(self.args['stages']):
            if s not in ['0', '1', '2', '3']:
                raise NotImplementedError

    def get_stage_parameters(self, stage):
        return {
            'batch_size': self.args[f's{stage}_batch_size'],
            'iterations': self.args[f's{stage}_iterations'],
            'finetune': self.args[f's{stage}_finetune'],
            'steps': self.args[f's{stage}_steps'],
            'lr': self.args[f's{stage}_lr'],
            'num_ref_frames': self.args[f's{stage}_num_ref_frames'],
            'num_frames': self.args[f's{stage}_num_frames'],
            'start_warm': self.args[f's{stage}_start_warm'],
            'end_warm': self.args[f's{stage}_end_warm'],
        }

    def __getitem__(self, key):
        return self.args[key]

    def __setitem__(self, key, value):
        self.args[key] = value

    def __str__(self):
        return str(self.args)
