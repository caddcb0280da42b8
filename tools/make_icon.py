#!/usr/bin/env python
'''
Generate ``kvarq_tpu/gui/res/icon.png`` -- the GUI window icon (the
reference ships ``res/TPH_DNA.ico``; this is an original, deterministic
drawing: a DNA double helix over an orange tile).
'''

import math
import os

from PIL import Image, ImageDraw

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, os.pardir, 'kvarq_tpu', 'gui', 'res',
                   'icon.png')

S = 64


def main():
    img = Image.new('RGBA', (S, S), (0, 0, 0, 0))
    d = ImageDraw.Draw(img)
    # rounded orange tile
    d.rounded_rectangle([2, 2, S - 3, S - 3], radius=12,
                        fill=(253, 176, 92, 255),
                        outline=(168, 100, 18, 255), width=2)
    # double helix: two phase-shifted sinusoids + base-pair rungs
    cx, amp, turns = S // 2, 14, 1.5
    ys = list(range(10, S - 9))
    for phase, color in ((0.0, (53, 80, 110, 255)),
                         (math.pi, (27, 110, 60, 255))):
        pts = [(cx + amp * math.sin(
            2 * math.pi * turns * (y - ys[0]) / len(ys) + phase), y)
            for y in ys]
        d.line(pts, fill=color, width=4, joint='curve')
    for i, y in enumerate(ys[3::7]):
        t = 2 * math.pi * turns * (y - ys[0]) / len(ys)
        x1 = cx + amp * math.sin(t)
        x2 = cx + amp * math.sin(t + math.pi)
        d.line([(x1, y), (x2, y)], fill=(120, 86, 40, 255), width=2)
    img.save(OUT)
    print('wrote %s (%dx%d)' % (OUT, S, S))


if __name__ == '__main__':
    main()
