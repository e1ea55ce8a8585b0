"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives, at the card's full power limit
(NVIDIA's H100 SXM data sheet, dense rates): float32 outside the tensor
cores and HBM bandwidth.  A card not listed gets no roofline share."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32_flop_per_s": 67e12,
                              "hbm_byte_per_s": 3.35e12},
}
