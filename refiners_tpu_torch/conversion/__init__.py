from refiners_tpu_torch.conversion.jax_bridge import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw

__all__ = ["load_jax_state_dict", "nchw_to_nhwc", "nhwc_to_nchw"]
