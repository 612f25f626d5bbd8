"""Train an ORB bag-of-words vocabulary from a directory of images with the
PyTorch port (the counterpart of tools/train_vocab.py, with the same flags
plus --device).  ORB is extracted by the port's front end on the CUDA card
(or on the CPU with --device cpu); the flat vocabulary (default) or the
hierarchical tree (``--tree k L``) is trained on the host and written as an
``.npz`` that every runner loads with ``--vocab``.

Usage:
  python3 tools/train_vocab_torch.py -i /data/frames -o my_vocab.npz --words 1024
  python3 tools/train_vocab_torch.py -i /data/frames -o tree.npz --tree 10 3
  python3 tools/train_vocab_torch.py --synthetic 96 -o synth.npz
"""
import argparse
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synthetic_images(n_images: int, seed: int = 42):
    """Diverse synthetic training frames: patch scenes, textured planes and
    room walls across several noise-octave families (broader texture
    statistics than any one test renderer), drawn as tools/train_vocab.py
    draws them."""
    from openvslam_tpu_torch.camera import Perspective
    from openvslam_tpu_torch.utils import synthetic

    cam = Perspective(fx=350.0, fy=350.0, cx=208.0, cy=160.0, cols=416, rows=320)
    rng = np.random.default_rng(seed)
    octave_families = [
        ((4, 0.2), (16, 0.4), (64, 1.0), (128, 0.6)),
        ((2, 0.6), (8, 0.9), (32, 0.7)),
        ((16, 1.0), (48, 0.8), (160, 0.4)),
        ((6, 0.3), (24, 1.0), (96, 0.9), (192, 0.3)),
    ]
    imgs = []
    per = max(1, n_images // (len(octave_families) * 3))
    for octs in octave_families:
        # a patch scene (point features)
        sc = synthetic.PatchSceneRenderer(rng, n_points=600, rows=320, cols=416)
        poses = synthetic.orbit_trajectory(per, radius=2.2, target=(0, 0, 6), arc=np.pi / 5)
        imgs += [sc.render(cam, poses[i]) for i in range(per)]
        # a textured plane (continuous texture)
        pl = synthetic.PlaneSceneRenderer(rng, rows=320, cols=416, octaves=octs,
                                          dots=bool(rng.integers(2)))
        poses = synthetic.orbit_trajectory(per, radius=2.5, target=(2, 0, 7), arc=np.pi / 4)
        imgs += [pl.render(cam, poses[i]) for i in range(per)]
        # room walls (several planes, grazing angles)
        rm = synthetic.RoomSceneRenderer(rng, half=9.0, rows=320, cols=416,
                                         n_walls=int(rng.integers(6, 11)), octaves=octs)
        poses = synthetic.lap_trajectory(per, radius=5.0, laps=per / 140)
        imgs += [rm.render(cam, poses[i]) for i in range(per)]
    return imgs


def extract_descriptors(images, max_keypts: int, num_levels: int, device="cuda"):
    """(N, 256) int8 bits of every valid ORB descriptor of ``images``,
    extracted by the port's front end on ``device``."""
    import torch

    from openvslam_tpu_torch.models.frontend import OrbFrontend
    from openvslam_tpu_torch.ops.orb import unpack_bits_i8

    fe, descs = None, []
    for i, img in enumerate(images):
        if fe is None:
            fe = OrbFrontend(rows=img.shape[0], cols=img.shape[1], max_keypts=max_keypts,
                             num_levels=num_levels, device=device)
        kp = fe.extract(torch.from_numpy(np.ascontiguousarray(img)).to(fe.device))
        descs.append(unpack_bits_i8(kp.desc_u32)[kp.valid].cpu().numpy())
        if (i + 1) % 20 == 0:
            print(f"  extracted {i + 1}/{len(images)} images "
                  f"({sum(len(d) for d in descs)} descriptors)")
    return np.concatenate(descs, 0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--image-dir",
                   help="directory of training images (omit with --synthetic)")
    p.add_argument("--synthetic", type=int, metavar="N",
                   help="train on N diverse synthetic frames instead of an image directory")
    p.add_argument("-o", "--out", required=True, help="output .npz path")
    p.add_argument("--ext", default="png")
    p.add_argument("--words", type=int, default=1024, help="flat vocabulary size")
    p.add_argument("--tree", nargs=2, type=int, metavar=("K", "L"),
                   help="train a hierarchical tree (branching K, L levels) instead of a "
                        "flat vocabulary")
    p.add_argument("--max-images", type=int, default=200)
    p.add_argument("--max-keypts", type=int, default=1000)
    p.add_argument("--num-levels", type=int, default=8)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the ORB extraction (default: the CUDA card)")
    args = p.parse_args(argv)

    from openvslam_tpu_torch.data.bow import TreeVocabulary, Vocabulary

    if args.synthetic:
        images = synthetic_images(args.synthetic, seed=args.seed + 42)
        print(f"rendered {len(images)} diverse synthetic frames")
    else:
        if not args.image_dir:
            p.error("need --image-dir or --synthetic N")
        from openvslam_tpu_torch.utils.datasets import _imread_gray
        files = sorted(glob.glob(os.path.join(args.image_dir, f"*.{args.ext}")))
        if not files:
            p.error(f"no *.{args.ext} images under {args.image_dir}")
        step = max(1, len(files) // args.max_images)
        files = files[::step][:args.max_images]
        images = [_imread_gray(f) for f in files]

    descs = extract_descriptors(images, args.max_keypts, args.num_levels, args.device)
    print(f"training on {len(descs)} descriptors from {len(images)} images")
    if args.tree:
        k, levels = args.tree
        vocab = TreeVocabulary.train(descs, k=k, levels=levels, iters=args.iters, seed=args.seed)
        print(f"tree vocabulary: k={k} L={levels} ({vocab.num_words} leaf words)")
    else:
        vocab = Vocabulary.train(descs, num_words=args.words, iters=args.iters, seed=args.seed)
        print(f"flat vocabulary: {vocab.num_words} words")
    vocab.save(args.out)
    print(f"saved -> {args.out}")
    return vocab


if __name__ == "__main__":
    main()
