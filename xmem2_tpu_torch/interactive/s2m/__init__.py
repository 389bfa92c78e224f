from xmem2_tpu_torch.interactive.s2m.controller import S2MController
from xmem2_tpu_torch.interactive.s2m.network import (
    S2MNet, build_s2m, load_s2m_state_dict)
