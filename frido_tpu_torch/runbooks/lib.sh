# Sourced by the runbooks, which run from the repository root. DEVICE,
# when set, is passed to the CLIs as --device (DEVICE=cpu for the CPU);
# unset, they run on the card.

# The cards this process may use, on one line: CUDA_VISIBLE_DEVICES's
# list when it is set, else every card nvidia-smi lists (none without it).
visible_cards() {
  if [ -n "${CUDA_VISIBLE_DEVICES+set}" ]; then
    echo "${CUDA_VISIBLE_DEVICES//,/ }"
  else
    nvidia-smi --query-gpu=index --format=csv,noheader 2>/dev/null \
      | tr '\n' ' '
    echo
  fi
}

# The ranks of a training run: one a card, or 1 on the device DEVICE names.
n_ranks() {
  if [ -n "${DEVICE:-}" ]; then
    echo 1
    return
  fi
  local cards
  read -r -a cards <<< "$(visible_cards)"
  if [ "${#cards[@]}" -lt 1 ]; then
    echo "no CUDA device visible; DEVICE=cpu runs on the CPU" >&2
    return 1
  fi
  echo "${#cards[@]}"
}

# The cards the shards of a sampling run go round, on one line: the
# visible ones; none when DEVICE is set.
shard_cards() {
  if [ -z "${DEVICE:-}" ]; then
    visible_cards
  fi
}

# on_card I CMD ARGS...: CMD with CUDA_VISIBLE_DEVICES at card I mod the
# count of CARDS (an array the caller fills from shard_cards); unpinned
# when CARDS is empty.
on_card() {
  local i=$1
  shift
  if [ "${#CARDS[@]}" -gt 0 ]; then
    CUDA_VISIBLE_DEVICES=${CARDS[$((i % ${#CARDS[@]}))]} "$@"
  else
    "$@"
  fi
}

# wait_shards PID...: wait on every shard; 1 if any of them failed.
wait_shards() {
  local status=0 i=0 pid
  for pid in "$@"; do
    if ! wait "$pid"; then
      echo "shard $i of $# failed" >&2
      status=1
    fi
    i=$((i + 1))
  done
  return "$status"
}
