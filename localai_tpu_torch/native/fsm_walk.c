/* Native DFA-over-token-trie walk: the host-side hot loop of
 * grammar-constrained decoding (copy of localai_tpu/native/fsm_walk.c).
 *
 * Token masks are computed on the host between device steps, so this walk
 * sits on the per-token latency path of every constrained request
 * (function calling, response_format) whenever a DFA state is met for the
 * first time.
 *
 * The trie stores nodes in creation order, so every parent id precedes its
 * children: one linear pass computes each node's DFA state from its
 * parent's. The plain version does the same with one numpy gather per
 * trie LEVEL (functions/constraint.py TokenTrie.walk_numpy); this loop is
 * a single cache-friendly O(n_nodes) pass with no temporary index arrays.
 * Built at first use by native/__init__.py (cc -O3 -fPIC -shared); the
 * numpy path remains the fallback when no compiler exists.
 */

#include <stdint.h>

/* states[i] = trans[states[parent[i]] * n_classes + byte_class[edge[i]]]
 * for i in [1, n_nodes); states[0] is the start state (pre-filled).
 * trans rows for the DEAD state (-1) are handled by the caller giving a
 * DEAD row in trans itself (the DFA stores total transitions). */
void fsm_walk(const int32_t *trans, int32_t n_classes,
              const uint8_t *byte_class, const int64_t *parent,
              const int64_t *edge, int64_t n_nodes, int32_t *states) {
    for (int64_t i = 1; i < n_nodes; i++) {
        int32_t ps = states[parent[i]];
        states[i] = trans[(int64_t)ps * n_classes +
                          byte_class[edge[i]]];
    }
}

/* Mask build fused with the final-state gather: for each token id, row[id]
 * = 0.0f when the token is walkable and its leaf state is not DEAD, else
 * -1e30f. Saves two [V] temporaries per (state, grammar) cache miss. */
void fsm_mask(const int32_t *states, const int64_t *leaf_of_token,
              const uint8_t *token_ok, int64_t vocab, int32_t dead,
              float *row) {
    for (int64_t t = 0; t < vocab; t++) {
        row[t] = (token_ok[t] && states[leaf_of_token[t]] != dead)
                     ? 0.0f
                     : -1e30f;
    }
}
