"""TensorBoard logging (reference util/logger.py:22-100 surface): the part of
xmem2_tpu/utils/logger.py that training calls. TensorBoard is imported only
when an experiment id is given (not NULL)."""

import os
from typing import Optional


class TensorboardLogger:
    def __init__(self, short_id: str, long_id: Optional[str]):
        self.short_id = short_id
        if short_id is None or str(short_id).upper() == 'NULL':
            self.no_log = True
            print('Logging has been disabled.')
            self.logger = None
            return
        self.no_log = False
        from torch.utils.tensorboard import SummaryWriter
        log_dir = os.path.join('.', 'log', long_id or short_id)
        self.logger = SummaryWriter(log_dir)

    def log_scalar(self, tag, x, step):
        if self.no_log:
            return
        self.logger.add_scalar(tag, float(x), step)

    def log_string(self, tag, x):
        print(tag, x)
        if self.no_log:
            return
        self.logger.add_text(tag, x)
