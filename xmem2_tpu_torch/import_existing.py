"""Import an existing video + masks into a GUI workspace project.

    python -m xmem2_tpu_torch.import_existing --name NAME [--size 480]
        [--images DIR] [--masks DIR]

Counterpart of the root import_existing.py (reference
import_existing.py:23-87), writing the same tree byte for byte under
./workspace/NAME: frames resized (bilinear) and masks (nearest) to `size`
shorter side as frame_%06d files, masks converted to the DAVIS palette
with consistent object indices, info.json's num_objects. Host work only
(PIL); no device.
"""

import argparse
import json
from pathlib import Path

from PIL import Image

from xmem2_tpu_torch.utils.image_loader import PaletteConverter
from xmem2_tpu_torch.utils.palette import davis_palette


def resize_preserve(img: Image.Image, size: int, interpolation) -> Image.Image:
    h, w = img.height, img.width
    new_w = (w * size // min(w, h))
    new_h = (h * size // min(w, h))
    return img.resize((new_w, new_h), resample=interpolation)


def _empty_or_exit(p_out: Path, name: str, what: str) -> bool:
    p_out.mkdir(parents=True, exist_ok=True)
    if any(p_out.iterdir()):
        print(f'The project {name} already has {what} in the workspace. '
              f'Delete them first.')
        return False
    return True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--name', type=str, required=True,
                        help='Project name (folder in the workspace); created '
                             'if missing')
    parser.add_argument('--size', type=int, default=480)
    parser.add_argument('--images', type=str, required=False,
                        help='Path to the folder with video frames')
    parser.add_argument('--masks', type=str, required=False,
                        help='Path to the folder with existing masks')
    args = parser.parse_args(argv)

    p_project = Path('workspace') / str(args.name)
    if p_project.exists():
        print(f'Found the project {args.name} in the workspace.')
    else:
        print(f'Creating new project {args.name} in the workspace.')

    if args.images is not None:
        p_imgs_out = p_project / 'images'
        if not _empty_or_exit(p_imgs_out, args.name, 'images'):
            return 0
        img_files = sorted(Path(args.images).iterdir())
        print(f'Copying/resizing {len(img_files)} images')
        for i, p_img in enumerate(img_files):
            img = Image.open(p_img)
            resize_preserve(img, args.size, Image.Resampling.BILINEAR).save(
                p_imgs_out / f'frame_{i:06d}{p_img.suffix}')

    if args.masks is not None:
        p_masks_out = p_project / 'masks'
        if not _empty_or_exit(p_masks_out, args.name, 'masks'):
            return 0
        converter = PaletteConverter(davis_palette)
        mask_files = sorted(Path(args.masks).iterdir())
        print(f'Converting {len(mask_files)} masks to the DAVIS palette')
        for i, p_mask in enumerate(mask_files):
            mask = Image.open(p_mask)
            resized = resize_preserve(mask, args.size,
                                      Image.Resampling.NEAREST).convert('P')
            converter.image_to_index_mask(resized).save(
                p_masks_out / f'frame_{i:06d}{p_mask.suffix}')

        try:
            with open(p_project / 'info.json') as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        data['num_objects'] = converter.num_objects
        with open(p_project / 'info.json', 'wt') as f_out:
            json.dump(data, f_out, indent=4)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
