from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                        restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint.layout import (from_jax_train_state, layer_lists,
                                          stack_layers, to_jax_train_state,
                                          unstack_layers)
