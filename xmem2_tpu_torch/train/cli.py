"""Multi-stage training CLI, run as `python -m xmem2_tpu_torch.train`.

    python -m xmem2_tpu_torch.train --stages 02 [--device cpu] ...
    torchrun --nproc_per_node=N -m xmem2_tpu_torch.train --stages 2 ...

Counterpart of the root train.py (reference train.py:25-250): the stage
sequence (0 static images, 1 BL30K, 2/3 DAVIS + YouTubeVOS), the max_skip
curriculum, the finetune phase, the in-memory handoff of the weights from
one stage to the next (a single-object network gets its fifth value-encoder
channel, zero), and the crash-save in `finally`. Runs on CUDA unless given
--device cpu, and raises without a card. Under torchrun every rank trains
its share of the batch in DDP (NCCL on the card, gloo on the CPU); rank 0
logs and saves.

--stats PATH writes, per stage, what a measurement reads (rank 0): each
step's loss and its phases from CUDA events (data wait, forward, backward,
optimizer), which steps took the first batch of a fresh loader, the peak
device memory, and torch.profiler's device time by kernel over 3 steps
from the middle of the stage (away from the max_skip curriculum's loader
renewals at its start and end) with the window's wall time and the time the
device was busy in it.
"""

import datetime
import json
import math
import os
import time
from os import path

import numpy as np
import torch

from xmem2_tpu_torch.config import resolve_device
from xmem2_tpu_torch.train.configuration import Configuration
from xmem2_tpu_torch.utils.profiling import profiler

PROFILED_STEPS = 3


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = datasets
        self.cum = np.cumsum([len(d) for d in datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        di = int(np.searchsorted(self.cum, idx, side='right'))
        prev = 0 if di == 0 else int(self.cum[di - 1])
        return self.datasets[di][idx - prev]


def init_distributed(device: torch.device):
    """The default process group when torchrun started this process (it sets
    WORLD_SIZE, RANK, LOCAL_RANK and the rendezvous address): NCCL on the
    card, gloo on the CPU. A failed initialisation raises. Returns (rank,
    world size)."""
    if 'WORLD_SIZE' not in os.environ:
        return 0, 1
    if device.type == 'cuda':
        torch.cuda.set_device(int(os.environ['LOCAL_RANK']))
    torch.distributed.init_process_group(
        'nccl' if device.type == 'cuda' else 'gloo')
    return torch.distributed.get_rank(), torch.distributed.get_world_size()


class StageStats:
    """What --stats records for one stage (see the module docstring)."""

    def __init__(self, stage: str, config: dict, world: int, device):
        self.device = device
        self.steps = config['iterations'] + config['finetune']
        self.entry = {
            'stage': stage, 'batch_size': config['batch_size'],
            'world_size': world, 'num_frames': config['num_frames'],
            'crop_size': config['crop_size'], 'amp': config['amp'],
            'losses': [], 'fresh_loader_steps': [], 'phases_ms': [],
            'profiled_steps': [], 'peak_memory_bytes': None,
            'profile': None}
        self.profiler = None
        self.window_t0 = 0.0
        if device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(device)

    def before_step(self, step: int, fresh: bool):
        if fresh:
            self.entry['fresh_loader_steps'].append(step)
        if step == self.steps // 2 and self.steps >= 2 * PROFILED_STEPS \
                and self.device.type == 'cuda':
            torch.cuda.synchronize()
            self.profiler = profiler(self.device)
            self.profiler.__enter__()
            self.window_t0 = time.perf_counter()

    def after_step(self, step: int, losses):
        self.entry['losses'].append(losses['total_loss'].detach())
        if self.profiler is None or self.entry['profile'] is not None:
            return
        self.entry['profiled_steps'].append(step)
        if len(self.entry['profiled_steps']) < PROFILED_STEPS:
            return
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.window_t0
        self.profiler.__exit__(None, None, None)
        from torch.autograd import DeviceType

        def device_work(ev):   # kernels and copies, no annotated ranges
            return ev.device_type == DeviceType.CUDA and \
                not getattr(ev, 'is_user_annotation', False)

        kernels = []
        for ev in self.profiler.key_averages():
            us = getattr(ev, 'device_time_total', None)
            if us is None:
                us = getattr(ev, 'cuda_time_total', 0)
            if device_work(ev) and us > 0:
                kernels.append([ev.key, us, ev.count])
        # busy time: the union of the device work's intervals (kernels on
        # different streams, e.g. NCCL's beside backward, overlap)
        busy_us, end = 0.0, -math.inf
        for start, stop in sorted((ev.time_range.start, ev.time_range.end)
                                  for ev in self.profiler.events()
                                  if device_work(ev)):
            if stop > end:
                busy_us += stop - max(start, end)
                end = stop
        self.entry['profile'] = {'wall_s': wall, 'busy_s': busy_us / 1e6,
                                 'kernels': kernels}

    def finish(self, trainer) -> dict:
        e = self.entry
        e['losses'] = [float(v) for v in e['losses']]
        if self.device.type == 'cuda':
            torch.cuda.synchronize()
            e['peak_memory_bytes'] = torch.cuda.max_memory_allocated(
                self.device)
            prev = None
            for ev in trainer.step_events:
                start = ev['start'] if prev is None else prev['optimizer']
                e['phases_ms'].append({
                    'data': start.elapsed_time(ev['data']),
                    'forward': ev['data'].elapsed_time(ev['forward']),
                    'backward': ev['forward'].elapsed_time(ev['backward']),
                    'optimizer': ev['backward'].elapsed_time(
                        ev['optimizer'])})
                prev = ev
        return e


def main(argv=None):
    from xmem2_tpu_torch.bridge.torch_params import convert_state_dict, \
        load_state_dict_file, sniff_dims
    from xmem2_tpu_torch.models.init import init_params
    from xmem2_tpu_torch.train.loader import DataLoader
    from xmem2_tpu_torch.train.static_dataset import StaticTransformDataset
    from xmem2_tpu_torch.train.trainer import XMemTrainer
    from xmem2_tpu_torch.train.vos_dataset import VOSDataset
    from xmem2_tpu_torch.utils.load_subset import load_sub_davis, load_sub_yv
    from xmem2_tpu_torch.utils.logger import TensorboardLogger

    raw_config = Configuration()
    raw_config.parse(argv=argv)
    device = resolve_device(raw_config['device'])
    rank, world = init_distributed(device)
    if raw_config['benchmark']:
        torch.backends.cudnn.benchmark = True
    print(f'Training on {device}, rank {rank} of {world}')

    network_in_memory = None
    stages = raw_config['stages']
    all_stats = []
    try:
        for si, stage in enumerate(list(stages)):
            seed = 14159265
            np.random.seed(seed)
            torch.manual_seed(seed)

            stage_config = raw_config.get_stage_parameters(stage)
            config = dict(**raw_config.args, **stage_config)
            if config['exp_id'] != 'NULL':
                config['exp_id'] = config['exp_id'] + '_s%s' % stages[:si + 1]
            config['single_object'] = (stage == '0')
            if config['batch_size'] % world != 0:
                raise ValueError('Batch size must be divisible by the number '
                                 'of processes.')
            local_batch = config['batch_size'] // world
            print(f'Starting stage {stage} (batch {config["batch_size"]} '
                  f'over {world} process(es))')

            if config['exp_id'].lower() != 'null' and rank == 0:
                long_id = '%s_%s' % (
                    datetime.datetime.now().strftime('%b%d_%H.%M.%S'),
                    config['exp_id'])
            else:
                long_id = None
            logger = TensorboardLogger(config['exp_id'] if rank == 0
                                       else 'NULL', long_id)
            logger.log_string('hyperpara', str(config))

            # model init / stage handoff
            if network_in_memory is not None:
                print('Loading network from the previous stage')
                sd, dims = network_in_memory, sniff_dims(network_in_memory)
                network_in_memory = None
            elif raw_config['load_network'] is not None:
                print('Loading network from disk')
                sd, dims = load_state_dict_file(raw_config['load_network'])
                raw_config['load_network'] = None
            else:
                sd, dims = init_params(
                    key_dim=config['key_dim'], value_dim=config['value_dim'],
                    hidden_dim=config['hidden_dim'],
                    single_object=config['single_object'], seed=seed)
            if not config['single_object']:
                # a single-object network (stage 0's, or a JAX .npz of it)
                # gets a zero fifth channel (reference load_network_in_memory)
                sd, dims = convert_state_dict(sd)

            trainer = XMemTrainer(
                config, sd, dims, logger=logger,
                save_path=path.join('saves', long_id, long_id)
                if long_id else None, device=device,
                record_events=config['stats'] is not None)

            if raw_config['load_checkpoint'] is not None:
                total_iter = trainer.load_checkpoint(
                    raw_config['load_checkpoint'])
                raw_config['load_checkpoint'] = None
                print('Previously trained model loaded!')
            else:
                total_iter = 0

            # --- datasets + curriculum (reference train.py:119-190) -------
            def construct_loader(dataset):
                return DataLoader(dataset, local_batch, shuffle=True,
                                  num_workers=config['num_workers'],
                                  rank=rank, world_size=world, seed=seed)

            max_skip_values = [10, 15, 5, 5]
            renew_loader = None

            if stage == '0':
                static_root = path.expanduser(config['static_root'])
                train_dataset = StaticTransformDataset([
                    (path.join(static_root, 'fss'), 0, 1),
                    (path.join(static_root, 'DUTS-TR'), 1, 1),
                    (path.join(static_root, 'DUTS-TE'), 1, 1),
                    (path.join(static_root, 'ecssd'), 1, 1),
                    (path.join(static_root, 'BIG_small'), 1, 5),
                    (path.join(static_root, 'HRSOD_small'), 1, 5),
                ], num_frames=config['num_frames'], seed=seed,
                    crop_size=config['crop_size'])
                train_loader = construct_loader(train_dataset)
                print(f'Static dataset size: {len(train_dataset)}')
                increase_skip_fraction = [100]
            elif stage == '1':
                increase_skip_fraction = [0.1, 0.3, 0.8, 100]
                bl_root = path.expanduser(config['bl_root'])

                def renew_loader(max_skip, finetune=False):
                    ds = VOSDataset(path.join(bl_root, 'JPEGImages'),
                                    path.join(bl_root, 'Annotations'),
                                    max_skip, is_bl=True,
                                    num_frames=config['num_frames'],
                                    finetune=finetune, seed=seed,
                                    crop_size=config['crop_size'])
                    print(f'Blender dataset size: {len(ds)} '
                          f'(max_skip={max_skip})')
                    return construct_loader(ds)

                train_loader = renew_loader(5)
            else:
                increase_skip_fraction = [0.1, 0.3, 0.9, 100]
                yv_root = path.join(path.expanduser(config['yv_root']),
                                    'train_480p')
                davis_root = path.join(path.expanduser(config['davis_root']),
                                       '2017', 'trainval')

                def renew_loader(max_skip, finetune=False):
                    # //5: YouTubeVOS has annotations every five frames
                    yv = VOSDataset(path.join(yv_root, 'JPEGImages'),
                                    path.join(yv_root, 'Annotations'),
                                    max_skip // 5, is_bl=False,
                                    subset=load_sub_yv(),
                                    num_frames=config['num_frames'],
                                    finetune=finetune, seed=seed,
                                    crop_size=config['crop_size'])
                    davis = VOSDataset(
                        path.join(davis_root, 'JPEGImages', '480p'),
                        path.join(davis_root, 'Annotations', '480p'),
                        max_skip, is_bl=False, subset=load_sub_davis(),
                        num_frames=config['num_frames'], finetune=finetune,
                        seed=seed, crop_size=config['crop_size'])
                    ds = ConcatDataset([davis] * 5 + [yv])
                    print(f'DAVIS size: {len(davis)}, YouTube size: '
                          f'{len(yv)}, concat: {len(ds)} '
                          f'(max_skip={max_skip})')
                    return construct_loader(ds)

                train_loader = renew_loader(5)

            total_epoch = math.ceil(config['iterations']
                                    / max(len(train_loader), 1))
            current_epoch = total_iter // max(len(train_loader), 1)
            print(f'We approximately use {total_epoch} epochs.')
            change_skip_iter = [round(config['iterations'] * f)
                                for f in increase_skip_fraction]
            cur_skip = 5
            stats = StageStats(stage, config, world, device) \
                if config['stats'] and rank == 0 else None

            finetuning = False
            try:
                while total_iter < config['iterations'] + config['finetune']:
                    train_loader.set_epoch(current_epoch)
                    current_epoch += 1
                    print(f'Current epoch: {current_epoch}')

                    fresh = True
                    for data in train_loader:
                        if stage != '0' and total_iter >= change_skip_iter[0]:
                            while total_iter >= change_skip_iter[0]:
                                cur_skip = max_skip_values[0]
                                max_skip_values = max_skip_values[1:]
                                change_skip_iter = change_skip_iter[1:]
                            print(f'Changing max_skip to {cur_skip}')
                            train_loader = renew_loader(cur_skip)
                            break

                        if (config['finetune'] > 0 and not finetuning
                                and total_iter >= config['iterations']
                                and renew_loader is not None):
                            train_loader = renew_loader(cur_skip,
                                                        finetune=True)
                            finetuning = True
                            trainer.save_network_interval = 1000
                            break

                        if stats is not None:
                            stats.before_step(total_iter, fresh)
                        losses = trainer.do_pass(
                            data, total_iter,
                            record=config['stats'] is not None)
                        if stats is not None:
                            stats.after_step(total_iter, losses)
                        fresh = False
                        total_iter += 1
                        if total_iter >= config['iterations'] \
                                + config['finetune']:
                            break
            finally:
                if not config['debug'] and long_id is not None \
                        and total_iter > 5000:
                    trainer.save_network(total_iter)
                    trainer.save_checkpoint(total_iter)

            if stats is not None:
                all_stats.append(stats.finish(trainer))
                with open(config['stats'], 'w') as f:
                    json.dump(all_stats, f)
            network_in_memory = trainer.network_state()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
