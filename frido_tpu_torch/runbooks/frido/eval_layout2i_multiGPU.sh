#!/usr/bin/env bash
# Alias of eval_layout2i_multishard.sh, under the reference's name.
exec "$(dirname "$0")/eval_layout2i_multishard.sh" "$@"
