"""Unified metric CLI (mhada_tpu/evals/cli.py:1-74; reference
eval.py:311-339).

Usage:
  python -m mhada_tpu_torch.evals.cli -m MODE -p0 PATH0 -p1 PATH1 [weights]
      [--device cpu]

Modes: lpips | ssim | kl | gram | moment | uni | entropy | sifid |
debug_sifid (the reference's set; lpips, gram and sifid need the backbone
``.pth`` files named below).  SSIM, LPIPS, gram and SIFID's activations run
on ``--device``, the card unless ``--device cpu``.
"""

import argparse

from . import metrics


def main(argv=None):
    ap = argparse.ArgumentParser(
        usage="cli.py [-h] [-m MODE] [-p0 PATH0] [-p1 PATH1] [weights]",
    )
    ap.add_argument("-m", "--mode", default="lpips")
    ap.add_argument("-p0", "--path0", default="./results/stylized.png")
    ap.add_argument("-p1", "--path1", default="./results/style.png")
    ap.add_argument("--vgg19", help="torchvision VGG19 .pth (gram)")
    ap.add_argument("--vgg16", help="torchvision vgg16 .pth (lpips)")
    ap.add_argument("--lpips-heads", help="LPIPS v0.1 linear heads .pth")
    ap.add_argument("--inception", help="torchvision inception_v3 .pth (sifid)")
    ap.add_argument("--device", default="cuda",
                    help="default: cuda; without a card pass --device cpu")
    opt = ap.parse_args(argv)

    def need(flag, *values):
        if not all(values):
            ap.error(f"-m {opt.mode} needs {flag}")

    if opt.mode == "lpips":
        from .lpips import lpips_distance

        need("--vgg16 and --lpips-heads", opt.vgg16, opt.lpips_heads)
        print("Distance: %f" % lpips_distance(
            opt.path0, opt.path1, opt.vgg16, opt.lpips_heads, opt.device))
    elif opt.mode == "ssim":
        print("SSIM: %f" % metrics.ssim(opt.path0, opt.path1, opt.device))
    elif opt.mode == "kl":
        print("KL: %f" % metrics.kl_divergence(opt.path0, opt.path1))
    elif opt.mode == "gram":
        need("--vgg19", opt.vgg19)
        vgg = metrics.load_vgg19_features(opt.vgg19, opt.device)
        print("Gram Loss: %f" % metrics.gram_loss(opt.path0, opt.path1, vgg,
                                                  opt.device))
    elif opt.mode == "moment":
        print("Nth Order Moment: %f" % metrics.nth_order_moment(opt.path0))
    elif opt.mode == "uni":
        print("Uniformity: %f" % metrics.uniformity(opt.path0))
    elif opt.mode == "entropy":
        print("Average Entropy: %f" % metrics.average_entropy(opt.path0))
    elif opt.mode in ("sifid", "debug_sifid"):
        from .inception import load_inception
        from .sifid import SIFID

        need("--inception", opt.inception)
        model = load_inception(opt.inception, device=opt.device)
        if opt.mode == "sifid":
            print("SIFID: %f" % SIFID(model, 2048)(opt.path0, opt.path1))
        else:
            for dims in (64, 192, 768, 2048):
                v = SIFID(model, dims)(opt.path0, opt.path1)
                print(f"SIFID with {dims}D: {v:.6f}")
    else:
        raise SystemExit(f"unknown mode: {opt.mode}")


if __name__ == "__main__":
    main()
