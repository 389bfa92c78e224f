from xmem2_tpu_torch.inference.frame_selection.frame_selection import (  # noqa: F401
    first_frame_only,
    select_next_candidates,
    uniformly_selected_frames,
)
