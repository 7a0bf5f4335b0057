"""Operations of BigVGAN (``pipeline.vocoder``) from its shapes: conv_pre,
the transposed-conv upsamples, the AMP blocks' convolutions and conv_post,
2 operations a multiply-add. The anti-aliased activations' filter taps
are elementwise work and are not counted here (``act_conv`` counts them
for the pairs it covers)."""


def stages(voc: dict, mel_frames: int):
    """[(width, samples)] after each upsample."""
    out, ch, t = [], voc["upsample_initial_channel"], mel_frames
    for r in voc["upsample_rates"]:
        ch //= 2
        t *= r
        out.append((ch, t))
    return out


def output_samples(voc: dict, mel_frames: int) -> int:
    return stages(voc, mel_frames)[-1][1]


def flops(voc: dict, b: int, mel_frames: int) -> float:
    ch, t = voc["upsample_initial_channel"], mel_frames
    total = 2.0 * b * t * voc["num_mels"] * ch * 7          # conv_pre
    for (w, t_out), k in zip(stages(voc, mel_frames),
                             voc["upsample_kernel_sizes"]):
        total += 2.0 * b * t * ch * w * k                  # upsample
        for rk, dils in zip(voc["resblock_kernel_sizes"],
                            voc["resblock_dilation_sizes"]):
            total += 2 * len(dils) * 2.0 * b * t_out * w * w * rk
        ch, t = w, t_out
    return total + 2.0 * b * t * ch * 7                     # conv_post
